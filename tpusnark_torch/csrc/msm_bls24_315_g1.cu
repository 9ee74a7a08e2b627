// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BLS24-315 G1: 10-word Fp, 3b a Montgomery product. The strip passes and
// the shared Horner inline their products; the scan step calls them.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bls24_315_g1, BLS24_315, G1M, G1S)
