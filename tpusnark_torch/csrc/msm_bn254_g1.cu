// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BN254 G1: 8-word Fp, 3b = 9 (the add chain). The strip passes and the
// shared Horner inline their products; the scan step calls them.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bn254_g1, BN254, G1M, G1S)
