// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BLS24-317 G2: Fp4 = Fp2[v]/(v^2 - (1 + u)) over Fp2 = Fp[u]/(u^2 + 1),
// 10-word Fp; the Fp4 product is a call in every kernel (curve.cuh's
// mul4_called).
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bls24_317_g2, BLS24_317, G4M, G4S)
