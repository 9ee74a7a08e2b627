// Elementwise BN254 field kernels over (8, N) limb-major words.
//
// Replaces the TPU kernels
//   B1  tpusnark/fields/jfield.py Field._mul_impl   (fused through fields/fuse.py)
//   B2  tpusnark/fields/jfield.py Field._from_mont_impl
// and gives add/sub/neg entry points, which tpusnark left to XLA but which
// torch cannot express on CUDA (it has no unsigned carry arithmetic).
//
// Bound on the H100: a mul reads 64 bytes and writes 32 per lane and does
// ~130 32-bit multiply-adds, so at 2^17 lanes it is launch- and
// memory-bound; one lane per thread with coalesced word rows is the simple
// design that reads every byte once. add/sub/neg are pure memory traffic.
#include "bn254.cuh"

using namespace bn254;

namespace {

template <int S>
__global__ void k_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store(out, n, i, mul<S>(load(a, n, i), load(b, n, i)));
}

template <int S>
__global__ void k_from_mont(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elt one = zero();
  one.w[0] = 1;
  // REDC(a) = a * 1 * R^-1: output <= p (p only for a = p, which is zero)
  store(out, n, i, mul<S>(load(a, n, i), one));
}

template <int S>
__global__ void k_add(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store(out, n, i, add<S>(load(a, n, i), load(b, n, i)));
}

template <int S>
__global__ void k_sub(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store(out, n, i, sub<S>(load(a, n, i), load(b, n, i)));
}

template <int S>
__global__ void k_neg(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store(out, n, i, neg<S>(load(a, n, i)));
}

constexpr int THREADS = 256;

}  // namespace

#define TS_FIELD_BINARY(NAME, KERNEL)                                                  \
  TS_EXPORT int NAME(int spec, const void* a, const void* b, void* out, long n,       \
                     void* stream) {                                                   \
    if (n <= 0) return 0;                                                              \
    cudaStream_t st = (cudaStream_t)stream;                                            \
    if (spec == FR)                                                                    \
      KERNEL<FR><<<ts_blocks(n, THREADS), THREADS, 0, st>>>(                           \
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);                  \
    else                                                                               \
      KERNEL<FP><<<ts_blocks(n, THREADS), THREADS, 0, st>>>(                           \
          (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);                  \
    return (int)cudaGetLastError();                                                    \
  }

#define TS_FIELD_UNARY(NAME, KERNEL)                                                   \
  TS_EXPORT int NAME(int spec, const void* a, void* out, long n, void* stream) {      \
    if (n <= 0) return 0;                                                              \
    cudaStream_t st = (cudaStream_t)stream;                                            \
    if (spec == FR)                                                                    \
      KERNEL<FR><<<ts_blocks(n, THREADS), THREADS, 0, st>>>((const uint32_t*)a,       \
                                                            (uint32_t*)out, n);        \
    else                                                                               \
      KERNEL<FP><<<ts_blocks(n, THREADS), THREADS, 0, st>>>((const uint32_t*)a,       \
                                                            (uint32_t*)out, n);        \
    return (int)cudaGetLastError();                                                    \
  }

TS_FIELD_BINARY(ts_field_mul, k_mul)
TS_FIELD_BINARY(ts_field_add, k_add)
TS_FIELD_BINARY(ts_field_sub, k_sub)
TS_FIELD_UNARY(ts_field_from_mont, k_from_mont)
TS_FIELD_UNARY(ts_field_neg, k_neg)
