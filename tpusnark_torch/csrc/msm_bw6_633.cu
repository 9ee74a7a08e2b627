// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BW6-633: 20-word Fp, the product a call (mont.cuh). G2 is the sextic twist
// over Fp itself, so both groups run one set of kernels, each launch with
// its own 3b from the host.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bw6_633_g1, BW6_633, G1M, G1S)
TS_MSM_ENTRY(ts_msm_bw6_633_g2, BW6_633, G1M, G1S)
