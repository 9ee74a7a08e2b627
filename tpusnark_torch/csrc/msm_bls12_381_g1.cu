// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BLS12-381 G1: 12-word Fp, 3b = 12 a Montgomery product. The strip
// passes and the shared Horner inline their products; the scan step calls them.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bls12_381_g1, BLS12_381, G1M, G1S)
