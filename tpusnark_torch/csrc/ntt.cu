// NTT butterflies over the BN254 scalar field, on flat (8, N) operands and
// (8, N) twiddle rows (the caller tiles each stage's twiddles).
//
// Replaces the TPU kernels
//   B3  tpusnark/poly/ntt.py NTT._butterfly   (e + o*w, e - o*w)
//   B4  tpusnark/poly/ntt.py NTT._butterfly4  (two DIT stages, 4 muls)
// The TPU's four-step split and packed twiddle layout exist for its (8, 128)
// tiling and are not carried over: the port runs plain iterative DIT stages,
// pairs of them through B4 and an odd last stage through B3.
//
// Bound on the H100: memory. B4 reads 7 and writes 4 element rows per lane
// for 4 muls, B3 reads 3 and writes 2 for 1 mul; one lane per thread keeps
// every access coalesced. Keeping several stages in shared memory is later
// work.
#include "bn254.cuh"

using namespace bn254;

namespace {

__global__ void k_butterfly(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                            const uint32_t* __restrict__ w, uint32_t* __restrict__ out_a,
                            uint32_t* __restrict__ out_b, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elt ev = load(e, n, i);
  Elt t = mul<FR>(load(o, n, i), load(w, n, i));
  store(out_a, n, i, add<FR>(ev, t));
  store(out_b, n, i, sub<FR>(ev, t));
}

__global__ void k_butterfly4(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
                             const uint32_t* __restrict__ x2, const uint32_t* __restrict__ x3,
                             const uint32_t* __restrict__ w1, const uint32_t* __restrict__ w2a,
                             const uint32_t* __restrict__ w2b, uint32_t* __restrict__ z0,
                             uint32_t* __restrict__ z1, uint32_t* __restrict__ z2,
                             uint32_t* __restrict__ z3, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elt tw = load(w1, n, i);
  Elt t1 = mul<FR>(load(x1, n, i), tw);
  Elt t3 = mul<FR>(load(x3, n, i), tw);
  Elt a0 = load(x0, n, i);
  Elt a2 = load(x2, n, i);
  Elt y0 = add<FR>(a0, t1), y1 = sub<FR>(a0, t1);
  Elt y2 = add<FR>(a2, t3), y3 = sub<FR>(a2, t3);
  Elt u2 = mul<FR>(y2, load(w2a, n, i));
  Elt u3 = mul<FR>(y3, load(w2b, n, i));
  store(z0, n, i, add<FR>(y0, u2));
  store(z1, n, i, add<FR>(y1, u3));
  store(z2, n, i, sub<FR>(y0, u2));
  store(z3, n, i, sub<FR>(y1, u3));
}

constexpr int THREADS = 256;

}  // namespace

TS_EXPORT int ts_ntt_butterfly(const void* e, const void* o, const void* w, void* out_a,
                               void* out_b, long n, void* stream) {
  if (n <= 0) return 0;
  k_butterfly<<<ts_blocks(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)e, (const uint32_t*)o, (const uint32_t*)w, (uint32_t*)out_a,
      (uint32_t*)out_b, n);
  return (int)cudaGetLastError();
}

// ptrs: x0, x1, x2, x3, w1, w2a, w2b (inputs), z0, z1, z2, z3 (outputs)
TS_EXPORT int ts_ntt_butterfly4(const void* ptrs_host, long n, void* stream) {
  if (n <= 0) return 0;
  const uint64_t* p = (const uint64_t*)ptrs_host;
  k_butterfly4<<<ts_blocks(n, THREADS), THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)p[0], (const uint32_t*)p[1], (const uint32_t*)p[2],
      (const uint32_t*)p[3], (const uint32_t*)p[4], (const uint32_t*)p[5],
      (const uint32_t*)p[6], (uint32_t*)p[7], (uint32_t*)p[8], (uint32_t*)p[9],
      (uint32_t*)p[10], n);
  return (int)cudaGetLastError();
}
