// B5/B6 (curve.cuh) for BW6-761: Fp of 24 words. G1 is y^2 = x^3 - 1 (3b =
// -3 mod p) and G2 the sextic twist y^2 = x^3 + 4 over Fp itself (3b = 12):
// both groups run the Fp kernels, each launch with its own 3b in Montgomery
// form from the host. The Fp2 nonresidue is unused.
#include "curve.cuh"

TS_EXPORT int ts_curve_bw6_761(int op, int g2, const void* in_ptrs, const void* out_ptrs,
                               const void* inf, const void* b3_host, long n, void* stream) {
  return ts::launch_curve<ts::BW6_761>(op, g2, in_ptrs, out_ptrs, inf, b3_host, n, stream);
}
