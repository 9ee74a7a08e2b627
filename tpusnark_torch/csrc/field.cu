// Elementwise field kernels over (N, lanes) limb-major words, one template
// per op instantiated for every field id of mont.cuh: BN254 fr/fp,
// BLS12-377 fr and BLS24-315 fr (8 words), BLS12-381 fr and BLS24-317 fr
// (9), BLS24-315 fp, BLS24-317 fp and BW6-633 fr (10), BLS12-381 fp,
// BLS12-377 fp and BW6-761 fr (12), BW6-633 fp (20), BW6-761 fp (24).
//
// Replaces the TPU kernels
//   B1  tpusnark/fields/jfield.py Field._mul_impl   (fused through fields/fuse.py)
//   B2  tpusnark/fields/jfield.py Field._from_mont_impl
// and gives add/sub/neg entry points, which tpusnark left to XLA but which
// torch cannot express on CUDA (it has no unsigned carry arithmetic). neg is
// built for the base fields only: no path negates a scalar.
//
// Bound on the H100: a mul reads 8N bytes and writes 4N per lane and does
// 4N^2 + N 32-bit multiply-adds (2N^2 word products, a low and a high half
// each, and N low halves for the m's: 264 at 8 words, 410 at 10, 588 at 12,
// 1,620 at 20, 2,328 at 24), so at 2^17 lanes it is launch- and memory-bound up to 12 words; one lane per thread with coalesced word
// rows is the simple design that reads every byte once. add/sub/neg are pure
// memory traffic.
#include "mont.cuh"

using namespace ts;

namespace {

template <int F>
__global__ void k_mul(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store<N>(out, n, i, mul<F>(load<N>(a, n, i), load<N>(b, n, i)));
}

template <int F>
__global__ void k_from_mont(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EltOf<F> one = zero<N>();
  one.w[0] = 1;
  // REDC(a) = a * 1 * R^-1: output <= p for any a < R (p only for zero)
  store<N>(out, n, i, mul<F>(load<N>(a, n, i), one));
}

template <int F>
__global__ void k_add(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store<N>(out, n, i, add<F>(load<N>(a, n, i), load<N>(b, n, i)));
}

template <int F>
__global__ void k_sub(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                      uint32_t* __restrict__ out, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store<N>(out, n, i, sub<F>(load<N>(a, n, i), load<N>(b, n, i)));
}

template <int F>
__global__ void k_neg(const uint32_t* __restrict__ a, uint32_t* __restrict__ out, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store<N>(out, n, i, neg<F>(load<N>(a, n, i)));
}

constexpr int THREADS = 256;

template <int F>
int launch_binary(int op, const void* a, const void* b, void* out, long n, cudaStream_t st) {
  auto A = (const uint32_t*)a;
  auto B = (const uint32_t*)b;
  auto O = (uint32_t*)out;
  int blocks = ts_blocks(n, THREADS);
  if (op == 0)
    k_mul<F><<<blocks, THREADS, 0, st>>>(A, B, O, n);
  else if (op == 1)
    k_add<F><<<blocks, THREADS, 0, st>>>(A, B, O, n);
  else
    k_sub<F><<<blocks, THREADS, 0, st>>>(A, B, O, n);
  return (int)cudaGetLastError();
}

template <int F>
int launch_unary(int op, const void* a, void* out, long n, cudaStream_t st) {
  auto A = (const uint32_t*)a;
  auto O = (uint32_t*)out;
  int blocks = ts_blocks(n, THREADS);
  if (op == 0) {
    k_from_mont<F><<<blocks, THREADS, 0, st>>>(A, O, n);
  } else {
    if constexpr (F == BN254_FP || F == BLS12_381_FP || F == BLS12_377_FP || F == BW6_761_FP ||
                  F == BLS24_315_FP || F == BLS24_317_FP || F == BW6_633_FP)
      k_neg<F><<<blocks, THREADS, 0, st>>>(A, O, n);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int binary(int op, int field, const void* a, const void* b, void* out, long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (field) {
    case BN254_FR: return launch_binary<BN254_FR>(op, a, b, out, n, st);
    case BN254_FP: return launch_binary<BN254_FP>(op, a, b, out, n, st);
    case BLS12_381_FR: return launch_binary<BLS12_381_FR>(op, a, b, out, n, st);
    case BLS12_381_FP: return launch_binary<BLS12_381_FP>(op, a, b, out, n, st);
    case BLS12_377_FR: return launch_binary<BLS12_377_FR>(op, a, b, out, n, st);
    case BLS12_377_FP: return launch_binary<BLS12_377_FP>(op, a, b, out, n, st);
    case BW6_761_FR: return launch_binary<BW6_761_FR>(op, a, b, out, n, st);
    case BW6_761_FP: return launch_binary<BW6_761_FP>(op, a, b, out, n, st);
    case BLS24_315_FR: return launch_binary<BLS24_315_FR>(op, a, b, out, n, st);
    case BLS24_315_FP: return launch_binary<BLS24_315_FP>(op, a, b, out, n, st);
    case BLS24_317_FR: return launch_binary<BLS24_317_FR>(op, a, b, out, n, st);
    case BLS24_317_FP: return launch_binary<BLS24_317_FP>(op, a, b, out, n, st);
    case BW6_633_FR: return launch_binary<BW6_633_FR>(op, a, b, out, n, st);
    case BW6_633_FP: return launch_binary<BW6_633_FP>(op, a, b, out, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

int unary(int op, int field, const void* a, void* out, long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (field) {
    case BN254_FR: return launch_unary<BN254_FR>(op, a, out, n, st);
    case BN254_FP: return launch_unary<BN254_FP>(op, a, out, n, st);
    case BLS12_381_FR: return launch_unary<BLS12_381_FR>(op, a, out, n, st);
    case BLS12_381_FP: return launch_unary<BLS12_381_FP>(op, a, out, n, st);
    case BLS12_377_FR: return launch_unary<BLS12_377_FR>(op, a, out, n, st);
    case BLS12_377_FP: return launch_unary<BLS12_377_FP>(op, a, out, n, st);
    case BW6_761_FR: return launch_unary<BW6_761_FR>(op, a, out, n, st);
    case BW6_761_FP: return launch_unary<BW6_761_FP>(op, a, out, n, st);
    case BLS24_315_FR: return launch_unary<BLS24_315_FR>(op, a, out, n, st);
    case BLS24_315_FP: return launch_unary<BLS24_315_FP>(op, a, out, n, st);
    case BLS24_317_FR: return launch_unary<BLS24_317_FR>(op, a, out, n, st);
    case BLS24_317_FP: return launch_unary<BLS24_317_FP>(op, a, out, n, st);
    case BW6_633_FR: return launch_unary<BW6_633_FR>(op, a, out, n, st);
    case BW6_633_FP: return launch_unary<BW6_633_FP>(op, a, out, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

TS_EXPORT int ts_field_mul(int field, const void* a, const void* b, void* out, long n, void* stream) {
  return binary(0, field, a, b, out, n, stream);
}
TS_EXPORT int ts_field_add(int field, const void* a, const void* b, void* out, long n, void* stream) {
  return binary(1, field, a, b, out, n, stream);
}
TS_EXPORT int ts_field_sub(int field, const void* a, const void* b, void* out, long n, void* stream) {
  return binary(2, field, a, b, out, n, stream);
}
TS_EXPORT int ts_field_from_mont(int field, const void* a, void* out, long n, void* stream) {
  return unary(0, field, a, out, n, stream);
}
TS_EXPORT int ts_field_neg(int field, const void* a, void* out, long n, void* stream) {
  return unary(1, field, a, out, n, stream);
}
