// B5/B6 (curve.cuh) for BN254: Fp of 8 words, G1 3b = 9 (add chain), G2
// over Fp[u]/(u^2 + 1) with 3b' = 3 * 3/(9 + u) passed in by the host.
#include "curve.cuh"

using BN254 = ts::Curve<ts::BN254_FP, 1, true>;

TS_EXPORT int ts_curve_bn254(int op, int g2, const void* in_ptrs, const void* out_ptrs,
                             const void* inf, const void* b3_host, long n, void* stream) {
  return ts::launch_curve<BN254>(op, g2, in_ptrs, out_ptrs, inf, b3_host, n, stream);
}
