// B5/B6 (curve.cuh) for BLS12-377: Fp of 12 words, G1 3b = 3 (a Montgomery
// product by 3 R mod p, as tpusnark's FpArith.mul_b3), G2 over
// Fp[u]/(u^2 + 5) with 3b' = 3/u = (0, -3/5), both passed in by the host.
#include "curve.cuh"

TS_EXPORT int ts_curve_bls12_377(int op, int g2, const void* in_ptrs, const void* out_ptrs,
                                 const void* inf, const void* b3_host, long n, void* stream) {
  return ts::launch_curve<ts::BLS12_377>(op, g2, in_ptrs, out_ptrs, inf, b3_host, n, stream);
}
