// B5/B6 (curve.cuh) for BLS24-315: Fp of 10 words, G1 3b = 3 (a Montgomery
// product by 3 R mod p, as tpusnark's FpArith.mul_b3), G2 over Fp4 =
// Fp2[v]/(v^2 - u), Fp2 = Fp[u]/(u^2 + 13), with 3b' = ((0, 0), (0, b3))
// passed in by the host; every Fp4 product is a call (mul4_called).
#include "curve.cuh"

TS_EXPORT int ts_curve_bls24_315(int op, int g2, const void* in_ptrs, const void* out_ptrs,
                                 const void* inf, const void* b3_host, long n, void* stream) {
  return ts::launch_curve<ts::BLS24_315>(op, g2, in_ptrs, out_ptrs, inf, b3_host, n, stream);
}
