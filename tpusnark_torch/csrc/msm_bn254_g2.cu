// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BN254 G2: Fp2 over 8-word Fp with u^2 = -1. The strip passes and
// the shared Horner inline the Fp2 product; the scan step calls it.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bn254_g2, BN254, G2M, G2S)
