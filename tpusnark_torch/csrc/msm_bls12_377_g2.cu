// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BLS12-377 G2: Fp2 over 12-word Fp with u^2 = -5; the Fp2 product is a call.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bls12_377_g2, BLS12_377, G2M, G2S)
