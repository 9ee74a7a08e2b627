// Microbenchmark of the Montgomery product (scripts/bench_mont_product.py),
// built apart from the port's library: each lane runs `reps` chained
// products in registers, x = x * y, so a launch reads and writes one element
// a lane and its time is the products'. Cases: the Fp product at every word
// count, inlined (mul_unrolled) and called (mul_called), the Fp2 product
// (mul2, mul2_called) and the Fp4 product (mul4_called). The script builds it
// as it is and with -DTS_MONT_CIOS_C (the earlier C product) and runs the
// two in turns.
#include "curve.cuh"

using namespace ts;

namespace {

enum How { INLINE = 0, CALLED = 1 };

template <int N>
__device__ __forceinline__ Elt<N> comp(const uint32_t* p, int c, long n, long i) {
  return load<N>(p + (long)c * N * n, n, i);
}

template <int N>
__device__ __forceinline__ void put(uint32_t* p, int c, long n, long i, const Elt<N>& v) {
  store<N>(p + (long)c * N * n, n, i, v);
}

// x and y: DEG components of N words, component c at rows [c N, (c + 1) N).
template <class C, int DEG, int HOW>
__global__ void k_chain(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, uint32_t* __restrict__ out,
                        long n, int reps) {
  constexpr int F = C::FP;
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if constexpr (DEG == 1) {
    EltOf<F> x = comp<N>(a, 0, n, i), y = comp<N>(b, 0, n, i);
#pragma unroll 1
    for (int r = 0; r < reps; r++) x = HOW == CALLED ? mul_called<F>(x, y) : mul_unrolled<F>(x, y);
    put<N>(out, 0, n, i, x);
  } else if constexpr (DEG == 2) {
    Elt2<F> x = {comp<N>(a, 0, n, i), comp<N>(a, 1, n, i)}, y = {comp<N>(b, 0, n, i), comp<N>(b, 1, n, i)};
#pragma unroll 1
    for (int r = 0; r < reps; r++) x = HOW == CALLED ? mul2_called<F, C::Q>(x, y) : mul2<F, C::Q>(x, y);
    put<N>(out, 0, n, i, x.c0);
    put<N>(out, 1, n, i, x.c1);
  } else {
    Elt4<F> x = {{comp<N>(a, 0, n, i), comp<N>(a, 1, n, i)}, {comp<N>(a, 2, n, i), comp<N>(a, 3, n, i)}};
    Elt4<F> y = {{comp<N>(b, 0, n, i), comp<N>(b, 1, n, i)}, {comp<N>(b, 2, n, i), comp<N>(b, 3, n, i)}};
#pragma unroll 1
    for (int r = 0; r < reps; r++) x = mul4_called<F, C::Q, C::Z0, C::Z1>(x, y);
    put<N>(out, 0, n, i, x.c0.c0);
    put<N>(out, 1, n, i, x.c0.c1);
    put<N>(out, 2, n, i, x.c1.c0);
    put<N>(out, 3, n, i, x.c1.c1);
  }
}

// A curve type that carries only a base field, for the Fp cases.
template <int F>
using Fp = Curve<F, 1, false>;

template <class C, int DEG, int HOW>
int launch(const void* a, const void* b, void* out, long n, int reps, cudaStream_t st) {
  constexpr int threads = 128;
  k_chain<C, DEG, HOW><<<ts_blocks(n, threads), threads, 0, st>>>((const uint32_t*)a, (const uint32_t*)b,
                                                                  (uint32_t*)out, n, reps);
  return (int)cudaGetLastError();
}

}  // namespace

// The cases, in scripts/bench_mont_product.py's order (CASES there).
TS_EXPORT int ts_bench_mont(int case_id, const void* a, const void* b, void* out, long n, int reps, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (case_id) {
    case 0: return launch<Fp<BN254_FR>, 1, INLINE>(a, b, out, n, reps, st);
    case 1: return launch<Fp<BN254_FR>, 1, CALLED>(a, b, out, n, reps, st);
    case 2: return launch<Fp<BLS12_381_FR>, 1, INLINE>(a, b, out, n, reps, st);
    case 3: return launch<Fp<BLS12_381_FR>, 1, CALLED>(a, b, out, n, reps, st);
    case 4: return launch<Fp<BLS24_315_FP>, 1, INLINE>(a, b, out, n, reps, st);
    case 5: return launch<Fp<BLS24_315_FP>, 1, CALLED>(a, b, out, n, reps, st);
    case 6: return launch<Fp<BLS12_381_FP>, 1, INLINE>(a, b, out, n, reps, st);
    case 7: return launch<Fp<BLS12_381_FP>, 1, CALLED>(a, b, out, n, reps, st);
    case 8: return launch<Fp<BW6_633_FP>, 1, INLINE>(a, b, out, n, reps, st);
    case 9: return launch<Fp<BW6_633_FP>, 1, CALLED>(a, b, out, n, reps, st);
    case 10: return launch<Fp<BW6_761_FP>, 1, INLINE>(a, b, out, n, reps, st);
    case 11: return launch<Fp<BW6_761_FP>, 1, CALLED>(a, b, out, n, reps, st);
    case 12: return launch<BN254, 2, INLINE>(a, b, out, n, reps, st);
    case 13: return launch<BLS12_381, 2, INLINE>(a, b, out, n, reps, st);
    case 14: return launch<BLS12_381, 2, CALLED>(a, b, out, n, reps, st);
    case 15: return launch<BLS24_315, 4, CALLED>(a, b, out, n, reps, st);
    case 16: return launch<BLS24_317, 4, CALLED>(a, b, out, n, reps, st);
  }
  return (int)cudaErrorInvalidValue;
}
