// NTT kernels over a scalar field: the transform's passes, each several DIT
// stages in shared memory, and the pointwise butterflies. Instantiated for
// the scalar fields: BN254 fr, BLS12-377 fr and BLS24-315 fr (8 words),
// BLS12-381 fr and BLS24-317 fr (9 words), BW6-633 fr (10 words) and BW6-761
// fr (12 words).
//
// Replaces the TPU kernels
//   B3  tpusnark/poly/ntt.py NTT._butterfly   (e + o*w, e - o*w)
//   B4  tpusnark/poly/ntt.py NTT._butterfly4  (two DIT stages, 4 muls)
// and the stage loop around them (NTT._stages). The TPU's four-step split
// exists for its (8, 128) tiling and is not carried over; its packed twiddle
// table is (stage s at columns [2^s - 1, 2^(s+1) - 1)).
//
// k_ntt_stages runs DIT stages s0 .. s0+m-1 of bit-reversed data, word-major
// (words, lanes), lanes = batch rows of n. Stage s pairs positions q and
// q + 2^s inside blocks of 2^(s+1) with twiddle w^((q mod 2^s) n / 2^(s+1)),
// read straight from the packed table at column 2^s - 1 + (q mod 2^s). The
// stages of one pass touch only the 2^m elements base + t 2^s0 (t < 2^m) of
// a group, so a pass is a set of independent groups: a block loads G groups
// (G 2^m elements, at most 512: 16 KB at 8 words, 24 KB at 12; 256 blocks
// at 2^17) into shared memory, word-major so that adjacent threads hit
// adjacent banks, runs the stages in pairs through B4's radix-4 step and an
// odd last one through B3's radix-2 step (a barrier between rounds), and
// writes the group back to the same positions. Adjacent threads take
// adjacent groups, whose elements are adjacent in device memory (runs of
// G >= 2 words past the first pass; one contiguous range at s0 = 0). A block
// touches only its own elements, so a pass may run in place. A transform of
// 2^17 or 2^22 is 3 passes.
//
// Bound on the H100: operations. A pass reads and writes each element once
// (plus its slice of the table) for m/2 products an element: a 2^17
// transform at 8 words is ~18 us of products at the card's rate and ~8 us of
// bytes over its 3 passes. Small strides in the first rounds of a pass
// (G 2^j < 32) conflict in shared memory (2-4 ways); a swizzle that removes
// this is later work.
//
// The pointwise k_butterfly / k_butterfly4 (flat (N, lanes) operands and
// twiddle rows) run the same __device__ steps; no path of the prove launches
// them any more.
#include "mont.cuh"

using namespace ts;

namespace {

// B3: (e, o) <- (e + o*w, e - o*w)
template <int F>
__device__ __forceinline__ void radix2(EltOf<F>& e, EltOf<F>& o, const EltOf<F>& w) {
  EltOf<F> t = mul<F>(o, w);
  o = sub<F>(e, t);
  e = add<F>(e, t);
}

// B4: stage s on (x0, x1) and (x2, x3) with w1, then stage s + 1 on (y0, y2)
// with w2a and (y1, y3) with w2b; (x0..x3) <- (y0+u2, y1+u3, y0-u2, y1-u3)
template <int F>
__device__ __forceinline__ void radix4(EltOf<F>& x0, EltOf<F>& x1, EltOf<F>& x2, EltOf<F>& x3,
                                       const EltOf<F>& w1, const EltOf<F>& w2a,
                                       const EltOf<F>& w2b) {
  EltOf<F> t1 = mul<F>(x1, w1);
  EltOf<F> t3 = mul<F>(x3, w1);
  EltOf<F> y0 = add<F>(x0, t1), y1 = sub<F>(x0, t1);
  EltOf<F> y2 = add<F>(x2, t3), y3 = sub<F>(x2, t3);
  EltOf<F> u2 = mul<F>(y2, w2a);
  EltOf<F> u3 = mul<F>(y3, w2b);
  x0 = add<F>(y0, u2);
  x1 = add<F>(y1, u3);
  x2 = sub<F>(y0, u2);
  x3 = sub<F>(y1, u3);
}

template <int F>
__global__ void k_butterfly(const uint32_t* __restrict__ e, const uint32_t* __restrict__ o,
                            const uint32_t* __restrict__ w, uint32_t* __restrict__ out_a,
                            uint32_t* __restrict__ out_b, long n) {
  constexpr int N = words_of(F);
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  EltOf<F> a = load<N>(e, n, i), b = load<N>(o, n, i);
  radix2<F>(a, b, load<N>(w, n, i));
  store<N>(out_a, n, i, a);
  store<N>(out_b, n, i, b);
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
  EltOf<F> a0 = load<N>(x0, n, i), a1 = load<N>(x1, n, i);
  EltOf<F> a2 = load<N>(x2, n, i), a3 = load<N>(x3, n, i);
  radix4<F>(a0, a1, a2, a3, load<N>(w1, n, i), load<N>(w2a, n, i), load<N>(w2b, n, i));
  store<N>(z0, n, i, a0);
  store<N>(z1, n, i, a1);
  store<N>(z2, n, i, a2);
  store<N>(z3, n, i, a3);
}

// one element of shared memory: word k of element i at sh[k * S + i]
template <int N>
__device__ __forceinline__ Elt<N> sh_load(const uint32_t* sh, int S, int i) {
  Elt<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = sh[k * S + i];
  return r;
}

template <int N>
__device__ __forceinline__ void sh_store(uint32_t* sh, int S, int i, const Elt<N>& a) {
#pragma unroll
  for (int k = 0; k < N; k++) sh[k * S + i] = a.w[k];
}

// Shared memory a block may hold (kernels.NTT_BLOCK_BYTES): the largest
// power of two of elements that fits, 512 at 8 to 12 words.
// scripts/bench_ntt_passes.py builds half and twice this beside it to time
// the choice. A block has a thread per radix-4 step of a round, at most 256.
#ifndef TS_NTT_STAGE_BYTES
#define TS_NTT_STAGE_BYTES (24 * 1024)
#endif
__host__ __device__ constexpr int stage_elems(int n_words) {
  int e = 1;
  while (2 * e * 4 * n_words <= TS_NTT_STAGE_BYTES) e *= 2;
  return e;
}
__host__ __device__ constexpr int stage_threads(int n_words) {
  return stage_elems(n_words) / 4 < 256 ? stage_elems(n_words) / 4 : 256;
}

// Stages s0 .. s0+m-1 over x (N, lanes) into out (may be x). Group g has
// base (g >> s0) << (s0 + m) | (g mod 2^s0); a block holds the 2^lg_g
// groups from blockIdx.x 2^lg_g on, element t of group gl at shared index
// t 2^lg_g + gl. The table is (N, tw_cols) word-major.
template <int F>
__global__ void __launch_bounds__(stage_threads(words_of(F)))
    k_ntt_stages(const uint32_t* x, uint32_t* out, const uint32_t* __restrict__ table, long lanes,
                 long tw_cols, int s0, int m, int lg_g) {
  constexpr int N = words_of(F);
  extern __shared__ uint32_t sh[];
  const int G = 1 << lg_g;
  const int S = G << m;
  const long groups = lanes >> m;
  const long g0 = (long)blockIdx.x << lg_g;
  const long a_mask = (1L << s0) - 1;
  // groups adjacent in memory: all G, or the 2^s0 that share a high part
  const int lg_a = lg_g < s0 ? lg_g : s0;

  // load: f runs over the block's positions in address order
  for (int f = threadIdx.x; f < S; f += blockDim.x) {
    const int t = (f >> lg_a) & ((1 << m) - 1);
    const int gl = (f & ((1 << lg_a) - 1)) | ((f >> (lg_a + m)) << lg_a);
    const long g = g0 + gl;
    if (g >= groups) continue;
    const long pos = ((g >> s0) << (s0 + m)) | ((long)t << s0) | (g & a_mask);
#pragma unroll
    for (int k = 0; k < N; k++) sh[k * S + (t << lg_g) + gl] = x[k * lanes + pos];
  }
  __syncthreads();

  // stage pairs through B4's step; id = (r, gl) with gl fastest
  int j = 0;
  for (; j + 1 < m; j += 2) {
    const long half = 1L << (s0 + j);
    const int hj = 1 << j;
    for (int id = threadIdx.x; id < (S >> 2); id += blockDim.x) {
      const int gl = id & (G - 1), r = id >> lg_g;
      const long g = g0 + gl;
      if (g >= groups) continue;
      const int lowr = r & (hj - 1);
      const int t0 = lowr | ((r >> j) << (j + 2));
      const long q = (g & a_mask) | ((long)lowr << s0);  // position mod 2^s
      const int i0 = (t0 << lg_g) + gl, step = hj << lg_g;
      EltOf<F> a0 = sh_load<N>(sh, S, i0), a1 = sh_load<N>(sh, S, i0 + step);
      EltOf<F> a2 = sh_load<N>(sh, S, i0 + 2 * step), a3 = sh_load<N>(sh, S, i0 + 3 * step);
      radix4<F>(a0, a1, a2, a3, load<N>(table, tw_cols, half - 1 + q),
                load<N>(table, tw_cols, 2 * half - 1 + q), load<N>(table, tw_cols, 3 * half - 1 + q));
      sh_store<N>(sh, S, i0, a0);
      sh_store<N>(sh, S, i0 + step, a1);
      sh_store<N>(sh, S, i0 + 2 * step, a2);
      sh_store<N>(sh, S, i0 + 3 * step, a3);
    }
    __syncthreads();
  }
  // an odd last stage through B3's step
  if (j < m) {
    const long half = 1L << (s0 + j);
    const int hj = 1 << j;
    for (int id = threadIdx.x; id < (S >> 1); id += blockDim.x) {
      const int gl = id & (G - 1), r = id >> lg_g;
      const long g = g0 + gl;
      if (g >= groups) continue;
      const int lowr = r & (hj - 1);
      const int t0 = lowr | ((r >> j) << (j + 1));
      const long q = (g & a_mask) | ((long)lowr << s0);
      const int i0 = (t0 << lg_g) + gl, i1 = i0 + (hj << lg_g);
      EltOf<F> e = sh_load<N>(sh, S, i0), o = sh_load<N>(sh, S, i1);
      radix2<F>(e, o, load<N>(table, tw_cols, half - 1 + q));
      sh_store<N>(sh, S, i0, e);
      sh_store<N>(sh, S, i1, o);
    }
    __syncthreads();
  }

  // store: the load's positions
  for (int f = threadIdx.x; f < S; f += blockDim.x) {
    const int t = (f >> lg_a) & ((1 << m) - 1);
    const int gl = (f & ((1 << lg_a) - 1)) | ((f >> (lg_a + m)) << lg_a);
    const long g = g0 + gl;
    if (g >= groups) continue;
    const long pos = ((g >> s0) << (s0 + m)) | ((long)t << s0) | (g & a_mask);
#pragma unroll
    for (int k = 0; k < N; k++) out[k * lanes + pos] = sh[k * S + (t << lg_g) + gl];
  }
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

template <int F>
int launch_stages(const void* x, void* out, const void* table, long lanes, long tw_cols, int s0,
                  int m, int lg_g, cudaStream_t st) {
  constexpr int N = words_of(F);
  const long groups = lanes >> m;
  constexpr int ELEMS = stage_elems(N);
  const int bytes = (int)(sizeof(uint32_t) * N) << (lg_g + m);
  // the groups tile the lanes: rows of n = 2^k >= 2^(s0 + m)
  if ((1L << (lg_g + m)) > ELEMS || (lanes & ((1L << (s0 + m)) - 1)) != 0) return (int)cudaErrorInvalidValue;
  // above 48 KB a block's shared memory must be asked for, once per
  // instance; a refused launch never runs, so the caller gets its error
  static const cudaError_t attr = cudaFuncSetAttribute(
      k_ntt_stages<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(uint32_t) * N * ELEMS);
  if (attr != cudaSuccess) return (int)attr;
  const long blocks = (groups + (1L << lg_g) - 1) >> lg_g;
  k_ntt_stages<F><<<(unsigned)blocks, stage_threads(N), bytes, st>>>(
      (const uint32_t*)x, (uint32_t*)out, (const uint32_t*)table, lanes, tw_cols, s0, m, lg_g);
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
    case BLS12_377_FR: return launch_butterfly<BLS12_377_FR>(e, o, w, out_a, out_b, n, st);
    case BW6_761_FR: return launch_butterfly<BW6_761_FR>(e, o, w, out_a, out_b, n, st);
    case BLS24_315_FR: return launch_butterfly<BLS24_315_FR>(e, o, w, out_a, out_b, n, st);
    case BLS24_317_FR: return launch_butterfly<BLS24_317_FR>(e, o, w, out_a, out_b, n, st);
    case BW6_633_FR: return launch_butterfly<BW6_633_FR>(e, o, w, out_a, out_b, n, st);
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
    case BLS12_377_FR: return launch_butterfly4<BLS12_377_FR>(p, n, st);
    case BW6_761_FR: return launch_butterfly4<BW6_761_FR>(p, n, st);
    case BLS24_315_FR: return launch_butterfly4<BLS24_315_FR>(p, n, st);
    case BLS24_317_FR: return launch_butterfly4<BLS24_317_FR>(p, n, st);
    case BW6_633_FR: return launch_butterfly4<BW6_633_FR>(p, n, st);
  }
  return (int)cudaErrorInvalidValue;
}

// One pass of DIT stages s0 .. s0+m-1 over x (N, lanes) into out (which may
// be x), 2^lg_groups groups a block; table: (N, tw_cols) packed twiddles.
TS_EXPORT int ts_ntt_stages(int field, const void* x, void* out, const void* table, long lanes,
                            long tw_cols, int s0, int m, int lg_groups, void* stream) {
  if (lanes <= 0) return 0;
  if (m < 1 || s0 < 0 || lg_groups < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (field) {
    case BN254_FR: return launch_stages<BN254_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
    case BLS12_381_FR: return launch_stages<BLS12_381_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
    case BLS12_377_FR: return launch_stages<BLS12_377_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
    case BW6_761_FR: return launch_stages<BW6_761_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
    case BLS24_315_FR: return launch_stages<BLS24_315_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
    case BLS24_317_FR: return launch_stages<BLS24_317_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
    case BW6_633_FR: return launch_stages<BW6_633_FR>(x, out, table, lanes, tw_cols, s0, m, lg_groups, st);
  }
  return (int)cudaErrorInvalidValue;
}
