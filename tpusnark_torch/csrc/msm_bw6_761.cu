// The fused MSM kernels (msm.cuh: strip pass, scan step, window Horner) for
// BW6-761: 24-word Fp, the product a call (mont.cuh). G2 is the sextic twist
// over Fp itself, so both groups run one set of kernels, each launch with
// its own 3b from the host.
#include "msm.cuh"

TS_MSM_ENTRY(ts_msm_bw6_761_g1, BW6_761, G1M, G1S)
TS_MSM_ENTRY(ts_msm_bw6_761_g2, BW6_761, G1M, G1S)
