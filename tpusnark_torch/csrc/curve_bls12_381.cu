// B5/B6 (curve.cuh) for BLS12-381: Fp of 12 words, G1 3b = 12 (a
// Montgomery product by 12 R mod p, as tpusnark's FpArith.mul_b3), G2 over
// Fp[u]/(u^2 + 1) with 3b' = (12, 12), both passed in by the host.
#include "curve.cuh"

using BLS12_381 = ts::Curve<ts::BLS12_381_FP, 1, false>;

TS_EXPORT int ts_curve_bls12_381(int op, int g2, const void* in_ptrs, const void* out_ptrs,
                                 const void* inf, const void* b3_host, long n, void* stream) {
  return ts::launch_curve<BLS12_381>(op, g2, in_ptrs, out_ptrs, inf, b3_host, n, stream);
}
