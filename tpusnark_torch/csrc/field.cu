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
// 1,620 at 20, 2,328 at 24), so up to 12 words it is bound by memory, above
// it by the multiply-adds; from_mont (REDC alone) does half of them.
// add/sub/neg are pure memory traffic. One lane per thread with coalesced
// word rows reads every byte once. An operand may be one element for every
// lane (a broadcast constant: the block reads its words once into shared
// memory), and every operand may sit in rows of any stride (a column slice
// is read in place), so the callers copy nothing before a launch.
#include "mont.cuh"

using namespace ts;

namespace {

// An operand: word k of lane i at p[k * stride + i], or, where the launch
// says so (bcast), the same element for every lane, at p[k * stride].
template <int N>
__device__ __forceinline__ Elt<N> operand(const uint32_t* __restrict__ p, long stride, long i,
                                          bool bcast, const uint32_t* shared) {
  if (bcast) {
    Elt<N> r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = shared[k];
    return r;
  }
  return load<N>(p, stride, i);
}

// Loads a broadcast operand's words into shared memory once a block; every
// thread of the block passes the barrier.
template <int N>
__device__ __forceinline__ void stage_const(const uint32_t* __restrict__ p, long stride, bool bcast, uint32_t* shared) {
  if (bcast && threadIdx.x < N) shared[threadIdx.x] = p[threadIdx.x * stride];
}

enum BinaryOp { MUL = 0, ADD = 1, SUB = 2 };
enum UnaryOp { FROM_MONT = 0, NEG = 1 };

// bcast: bit 0, a is one element; bit 1, b is. Output rows of n lanes.
template <int F, int OP>
__global__ void k_binary(const uint32_t* __restrict__ a, long sa, const uint32_t* __restrict__ b, long sb,
                         uint32_t* __restrict__ out, long n, int bcast) {
  constexpr int N = words_of(F);
  __shared__ uint32_t ca[N], cb[N];
  if (bcast) {
    stage_const<N>(a, sa, bcast & 1, ca);
    stage_const<N>(b, sb, bcast & 2, cb);
    __syncthreads();
  }
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EltOf<F> x = operand<N>(a, sa, i, bcast & 1, ca), y = operand<N>(b, sb, i, bcast & 2, cb);
  if constexpr (OP == MUL)
    store<N>(out, n, i, mul<F>(x, y));
  else if constexpr (OP == ADD)
    store<N>(out, n, i, add<F>(x, y));
  else
    store<N>(out, n, i, sub<F>(x, y));
}

template <int F, int OP>
__global__ void k_unary(const uint32_t* __restrict__ a, long sa, uint32_t* __restrict__ out, long n, int bcast) {
  constexpr int N = words_of(F);
  __shared__ uint32_t ca[N];
  if (bcast) {
    stage_const<N>(a, sa, true, ca);
    __syncthreads();
  }
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EltOf<F> x = operand<N>(a, sa, i, bcast, ca);
  if constexpr (OP == FROM_MONT)
    store<N>(out, n, i, redc<F>(x));  // <= p for any x < R (p only for zero)
  else
    store<N>(out, n, i, neg<F>(x));
}

constexpr int THREADS = 256;

template <int F>
int launch_binary(int op, const void* a, long sa, const void* b, long sb, void* out, long n, int bcast,
                  cudaStream_t st) {
  auto A = (const uint32_t*)a;
  auto B = (const uint32_t*)b;
  auto O = (uint32_t*)out;
  int blocks = ts_blocks(n, THREADS);
  if (op == MUL)
    k_binary<F, MUL><<<blocks, THREADS, 0, st>>>(A, sa, B, sb, O, n, bcast);
  else if (op == ADD)
    k_binary<F, ADD><<<blocks, THREADS, 0, st>>>(A, sa, B, sb, O, n, bcast);
  else
    k_binary<F, SUB><<<blocks, THREADS, 0, st>>>(A, sa, B, sb, O, n, bcast);
  return (int)cudaGetLastError();
}

template <int F>
int launch_unary(int op, const void* a, long sa, void* out, long n, int bcast, cudaStream_t st) {
  auto A = (const uint32_t*)a;
  auto O = (uint32_t*)out;
  int blocks = ts_blocks(n, THREADS);
  if (op == FROM_MONT) {
    k_unary<F, FROM_MONT><<<blocks, THREADS, 0, st>>>(A, sa, O, n, bcast);
  } else {
    if constexpr (F == BN254_FP || F == BLS12_381_FP || F == BLS12_377_FP || F == BW6_761_FP ||
                  F == BLS24_315_FP || F == BLS24_317_FP || F == BW6_633_FP)
      k_unary<F, NEG><<<blocks, THREADS, 0, st>>>(A, sa, O, n, bcast);
    else
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Calls launch<F>(args...) for the field id f, or returns cudaErrorInvalidValue.
#define TS_FIELD_SWITCH(f, launch, ...)                                       \
  switch (f) {                                                                \
    case BN254_FR: return launch<BN254_FR>(__VA_ARGS__);                       \
    case BN254_FP: return launch<BN254_FP>(__VA_ARGS__);                       \
    case BLS12_381_FR: return launch<BLS12_381_FR>(__VA_ARGS__);               \
    case BLS12_381_FP: return launch<BLS12_381_FP>(__VA_ARGS__);               \
    case BLS12_377_FR: return launch<BLS12_377_FR>(__VA_ARGS__);               \
    case BLS12_377_FP: return launch<BLS12_377_FP>(__VA_ARGS__);               \
    case BW6_761_FR: return launch<BW6_761_FR>(__VA_ARGS__);                   \
    case BW6_761_FP: return launch<BW6_761_FP>(__VA_ARGS__);                   \
    case BLS24_315_FR: return launch<BLS24_315_FR>(__VA_ARGS__);               \
    case BLS24_315_FP: return launch<BLS24_315_FP>(__VA_ARGS__);               \
    case BLS24_317_FR: return launch<BLS24_317_FR>(__VA_ARGS__);               \
    case BLS24_317_FP: return launch<BLS24_317_FP>(__VA_ARGS__);               \
    case BW6_633_FR: return launch<BW6_633_FR>(__VA_ARGS__);                   \
    case BW6_633_FP: return launch<BW6_633_FP>(__VA_ARGS__);                   \
  }                                                                           \
  return (int)cudaErrorInvalidValue;

int binary(int op, int field, const void* a, long sa, const void* b, long sb, void* out, long n, int bcast,
           void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  TS_FIELD_SWITCH(field, launch_binary, op, a, sa, b, sb, out, n, bcast, st)
}

int unary(int op, int field, const void* a, long sa, void* out, long n, int bcast, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  TS_FIELD_SWITCH(field, launch_unary, op, a, sa, out, n, bcast, st)
}

}  // namespace

// Binary ops: a and b with word strides sa and sb (bcast bit 0: a is one
// element, bit 1: b is); out is (N, n), contiguous.
TS_EXPORT int ts_field_mul(int field, const void* a, long sa, const void* b, long sb, void* out, long n, int bcast,
                           void* stream) {
  return binary(MUL, field, a, sa, b, sb, out, n, bcast, stream);
}
TS_EXPORT int ts_field_add(int field, const void* a, long sa, const void* b, long sb, void* out, long n, int bcast,
                           void* stream) {
  return binary(ADD, field, a, sa, b, sb, out, n, bcast, stream);
}
TS_EXPORT int ts_field_sub(int field, const void* a, long sa, const void* b, long sb, void* out, long n, int bcast,
                           void* stream) {
  return binary(SUB, field, a, sa, b, sb, out, n, bcast, stream);
}
// Unary ops: a with word stride sa (bcast: one element for every lane).
TS_EXPORT int ts_field_from_mont(int field, const void* a, long sa, void* out, long n, int bcast, void* stream) {
  return unary(FROM_MONT, field, a, sa, out, n, bcast, stream);
}
TS_EXPORT int ts_field_neg(int field, const void* a, long sa, void* out, long n, int bcast, void* stream) {
  return unary(NEG, field, a, sa, out, n, bcast, stream);
}
