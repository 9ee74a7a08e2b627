// NTT butterflies over a scalar field, on flat (N, lanes) operands and
// (N, lanes) twiddle rows (the caller tiles each stage's twiddles).
// Instantiated for BN254 fr (8 words) and BLS12-381 fr (9 words).
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
#include "mont.cuh"

using namespace ts;

namespace {

template <int F>
__global__ void k_butterfly(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                            const uint32_t* __restrict__ w, uint32_t* __restrict__ out_a,
                            uint32_t* __restrict__ out_b, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EltOf<F> ev = load<N>(e, n, i);
  EltOf<F> t = mul<F>(load<N>(o, n, i), load<N>(w, n, i));
  store<N>(out_a, n, i, add<F>(ev, t));
  store<N>(out_b, n, i, sub<F>(ev, t));
}

template <int F>
__global__ void k_butterfly4(const uint32_t* __restrict__ x0, const uint32_t* __restrict__ x1,
                             const uint32_t* __restrict__ x2, const uint32_t* __restrict__ x3,
                             const uint32_t* __restrict__ w1, const uint32_t* __restrict__ w2a,
                             const uint32_t* __restrict__ w2b, uint32_t* __restrict__ z0,
                             uint32_t* __restrict__ z1, uint32_t* __restrict__ z2,
                             uint32_t* __restrict__ z3, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EltOf<F> tw = load<N>(w1, n, i);
  EltOf<F> t1 = mul<F>(load<N>(x1, n, i), tw);
  EltOf<F> t3 = mul<F>(load<N>(x3, n, i), tw);
  EltOf<F> a0 = load<N>(x0, n, i);
  EltOf<F> a2 = load<N>(x2, n, i);
  EltOf<F> y0 = add<F>(a0, t1), y1 = sub<F>(a0, t1);
  EltOf<F> y2 = add<F>(a2, t3), y3 = sub<F>(a2, t3);
  EltOf<F> u2 = mul<F>(y2, load<N>(w2a, n, i));
  EltOf<F> u3 = mul<F>(y3, load<N>(w2b, n, i));
  store<N>(z0, n, i, add<F>(y0, u2));
  store<N>(z1, n, i, add<F>(y1, u3));
  store<N>(z2, n, i, sub<F>(y0, u2));
  store<N>(z3, n, i, sub<F>(y1, u3));
}

constexpr int THREADS = 256;

template <int F>
int launch_butterfly(const void* e, const void* o, const void* w, void* out_a, void* out_b,
                     long n, cudaStream_t st) {
  k_butterfly<F><<<ts_blocks(n, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)e, (const uint32_t*)o, (const uint32_t*)w, (uint32_t*)out_a,
      (uint32_t*)out_b, n);
  return (int)cudaGetLastError();
}

template <int F>
int launch_butterfly4(const uint64_t* p, long n, cudaStream_t st) {
  k_butterfly4<F><<<ts_blocks(n, THREADS), THREADS, 0, st>>>(
      (const uint32_t*)p[0], (const uint32_t*)p[1], (const uint32_t*)p[2],
      (const uint32_t*)p[3], (const uint32_t*)p[4], (const uint32_t*)p[5],
      (const uint32_t*)p[6], (uint32_t*)p[7], (uint32_t*)p[8], (uint32_t*)p[9],
      (uint32_t*)p[10], n);
  return (int)cudaGetLastError();
}

}  // namespace

TS_EXPORT int ts_ntt_butterfly(int field, const void* e, const void* o, const void* w,
                               void* out_a, void* out_b, long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (field) {
    case BN254_FR: return launch_butterfly<BN254_FR>(e, o, w, out_a, out_b, n, st);
    case BLS12_381_FR: return launch_butterfly<BLS12_381_FR>(e, o, w, out_a, out_b, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ptrs: x0, x1, x2, x3, w1, w2a, w2b (inputs), z0, z1, z2, z3 (outputs)
TS_EXPORT int ts_ntt_butterfly4(int field, const void* ptrs_host, long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const uint64_t* p = (const uint64_t*)ptrs_host;
  switch (field) {
    case BN254_FR: return launch_butterfly4<BN254_FR>(p, n, st);
    case BLS12_381_FR: return launch_butterfly4<BLS12_381_FR>(p, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
