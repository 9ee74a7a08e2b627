// Complete projective group law for G1 (over Fp) and G2 (over Fp2 =
// Fp[u]/(u^2 + Q), or over Fp itself for BW6-761's sextic twist) of one
// curve, one point per thread. Each curve_<name>.cu instantiates it for one
// curve, so the curves build in parallel.
//
// Replaces the TPU kernels
//   B5  tpusnark/curves/jcurve.py FusedCurveOps.add_mixed  (RCB15 alg. 8)
//   B6  tpusnark/curves/jcurve.py FusedCurveOps.add        (RCB15 alg. 7)
// over FpArith (G1) and Fp2Arith (G2). The formulas run in the same order as
// jcurve.CurveOps, and mul_b3 follows tpusnark's FpArith.mul_b3: the add
// chain 8x + x where 3b = 9 (BN254), else a Montgomery product by 3b (in
// Montgomery form, passed in by the host, as mul_const does it). So the
// projective outputs equal tpusnark's coordinate by coordinate.
//
// Bound on the H100: integer multiply throughput and registers. A G1 add is
// 12-14 Montgomery products (~3,700 32-bit multiply-adds at 8 words, ~8,200
// at 12) against 9 element rows of traffic; a G2 add triples the products.
// An Fp2 element is 2N registers (24 at 12 words), so the G2 kernels spill
// at every width, and so do the 24-word kernels of BW6-761 (six 24-word
// inputs are 144 registers; their products are calls, see mont.cuh): one
// point per thread keeps them simple and right, and register pressure is
// later work.
#pragma once

#include "mont.cuh"

namespace ts {

// A curve as the kernels see it: its base field, its Fp2 nonresidue Q
// (u^2 = -Q), whether G1's 3b is 9, and whether G2 lies over Fp itself
// (then G2 runs the Fp kernels with its own 3b, and Q is unused).
template <int FP_, int Q_, bool G1_B3_IS_9_, bool G2_OVER_FP_ = false>
struct Curve {
  static constexpr int FP = FP_;
  static constexpr int Q = Q_;
  static constexpr bool G1_B3_IS_9 = G1_B3_IS_9_;
  static constexpr bool G2_OVER_FP = G2_OVER_FP_;
  // a G2 over Fp shares G1's kernels, so its 3b must be passed in too
  static_assert(!(G1_B3_IS_9_ && G2_OVER_FP_), "the 3b = 9 chain serves G1 only");
};

struct CurveArgs {
  const uint32_t* in[12];  // coordinate components, (N, lanes) each
  uint32_t* out[6];
  const uint8_t* inf;           // add_mixed only: lanes that return the first operand
  uint32_t b3[2 * MAX_WORDS];  // 3b (over Fp) or 3b' (over Fp2: c0 then c1), Montgomery form
};

template <class C>
struct G1F {
  static constexpr int F = C::FP;
  static constexpr int N = words_of(F);
  using E = EltOf<F>;
  __device__ static E add(const E& a, const E& b) { return ts::add<F>(a, b); }
  __device__ static E sub(const E& a, const E& b) { return ts::sub<F>(a, b); }
  __device__ static E mul(const E& a, const E& b) { return ts::mul<F>(a, b); }
  __device__ static E mul_b3(const E& x, const CurveArgs& args) {
    if constexpr (C::G1_B3_IS_9) {  // 9x = 8x + x
      E x2 = add(x, x);
      E x4 = add(x2, x2);
      E x8 = add(x4, x4);
      return add(x8, x);
    } else {
      E b3;
#pragma unroll
      for (int k = 0; k < N; k++) b3.w[k] = args.b3[k];
      return mul(x, b3);
    }
  }
  __device__ static E ld(const uint32_t* const* p, int c, long n, long i) {
    return load<N>(p[c], n, i);
  }
  __device__ static void st(uint32_t* const* p, int c, long n, long i, const E& v) {
    store<N>(p[c], n, i, v);
  }
};

template <class C>
struct G2F {
  static constexpr int F = C::FP;
  static constexpr int N = words_of(F);
  using E = Elt2<F>;
  __device__ static E add(const E& a, const E& b) { return add2<F>(a, b); }
  __device__ static E sub(const E& a, const E& b) { return sub2<F>(a, b); }
  __device__ static E mul(const E& a, const E& b) { return mul2<F, C::Q>(a, b); }
  __device__ static E mul_b3(const E& x, const CurveArgs& args) {
    E b3;
#pragma unroll
    for (int k = 0; k < N; k++) {
      b3.c0.w[k] = args.b3[k];
      b3.c1.w[k] = args.b3[N + k];
    }
    return mul(x, b3);
  }
  __device__ static E ld(const uint32_t* const* p, int c, long n, long i) {
    return {load<N>(p[2 * c], n, i), load<N>(p[2 * c + 1], n, i)};
  }
  __device__ static void st(uint32_t* const* p, int c, long n, long i, const E& v) {
    store<N>(p[2 * c], n, i, v.c0);
    store<N>(p[2 * c + 1], n, i, v.c1);
  }
};

// RCB15 algorithm 7 (a = 0), in jcurve.CurveOps.add's order.
template <class G>
__global__ void k_add(CurveArgs args, long n) {
  using E = typename G::E;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  E X1 = G::ld(args.in, 0, n, i), Y1 = G::ld(args.in, 1, n, i), Z1 = G::ld(args.in, 2, n, i);
  E X2 = G::ld(args.in, 3, n, i), Y2 = G::ld(args.in, 4, n, i), Z2 = G::ld(args.in, 5, n, i);
  E t0 = G::mul(X1, X2);
  E t1 = G::mul(Y1, Y2);
  E t2 = G::mul(Z1, Z2);
  E m3 = G::mul(G::add(X1, Y1), G::add(X2, Y2));
  E m4 = G::mul(G::add(Y1, Z1), G::add(Y2, Z2));
  E m5 = G::mul(G::add(X1, Z1), G::add(X2, Z2));
  E t3 = G::sub(m3, G::add(t0, t1));
  E t4 = G::sub(m4, G::add(t1, t2));
  E y3p = G::sub(m5, G::add(t0, t2));
  E x3 = G::add(t0, t0);
  E t0n = G::add(x3, t0);
  E t2b = G::mul_b3(t2, args);
  E y3b = G::mul_b3(y3p, args);
  E z3 = G::add(t1, t2b);
  E t1n = G::sub(t1, t2b);
  E r0 = G::mul(t4, y3b);
  E r1 = G::mul(t3, t1n);
  E r2 = G::mul(y3b, t0n);
  E r3 = G::mul(t1n, z3);
  E r4 = G::mul(t0n, t3);
  E r5 = G::mul(z3, t4);
  G::st(args.out, 0, n, i, G::sub(r1, r0));
  G::st(args.out, 1, n, i, G::add(r3, r2));
  G::st(args.out, 2, n, i, G::add(r5, r4));
}

// RCB15 algorithm 8 (a = 0, Z2 = 1), in jcurve.CurveOps.add_mixed's order.
template <class G>
__global__ void k_add_mixed(CurveArgs args, long n) {
  using E = typename G::E;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  E X1 = G::ld(args.in, 0, n, i), Y1 = G::ld(args.in, 1, n, i), Z1 = G::ld(args.in, 2, n, i);
  if (args.inf != nullptr && args.inf[i]) {
    G::st(args.out, 0, n, i, X1);
    G::st(args.out, 1, n, i, Y1);
    G::st(args.out, 2, n, i, Z1);
    return;
  }
  E X2 = G::ld(args.in, 3, n, i), Y2 = G::ld(args.in, 4, n, i);
  E t0 = G::mul(X1, X2);
  E t1 = G::mul(Y1, Y2);
  E m3 = G::mul(G::add(X1, Y1), G::add(X2, Y2));
  E mt4 = G::mul(X2, Z1);
  E mt5 = G::mul(Y2, Z1);
  E t3 = G::sub(m3, G::add(t0, t1));
  E t4 = G::add(mt4, X1);
  E t5 = G::add(mt5, Y1);
  E z3b = G::mul_b3(Z1, args);
  E y3b = G::mul_b3(t4, args);
  E x3 = G::add(t0, t0);
  E t0n = G::add(x3, t0);
  E z3 = G::add(t1, z3b);
  E t1n = G::sub(t1, z3b);
  E r0 = G::mul(t5, y3b);
  E r1 = G::mul(t3, t1n);
  E r2 = G::mul(y3b, t0n);
  E r3 = G::mul(t1n, z3);
  E r4 = G::mul(t0n, t3);
  E r5 = G::mul(z3, t5);
  G::st(args.out, 0, n, i, G::sub(r1, r0));
  G::st(args.out, 1, n, i, G::add(r3, r2));
  G::st(args.out, 2, n, i, G::add(r5, r4));
}

constexpr int THREADS_G1 = 256;
constexpr int THREADS_G2 = 128;

// op: 0 = add (B6), 1 = add_mixed (B5). in_ptrs/out_ptrs: host arrays of
// device pointers, one per coordinate component (G1: X, Y, Z; G2: X.c0,
// X.c1, Y.c0, ...). inf: (lanes,) bytes or null, add_mixed only. b3_host:
// N words of 3b (over Fp) or 2N of 3b' (over Fp2), Montgomery form.
template <class C>
int launch_curve(int op, int g2, const void* in_ptrs, const void* out_ptrs, const void* inf,
                 const void* b3_host, long n, void* stream) {
  if (n <= 0) return 0;
  constexpr int N = words_of(C::FP);
  cudaStream_t st = (cudaStream_t)stream;
  CurveArgs a = {};
  const uint64_t* ip = (const uint64_t*)in_ptrs;
  const uint64_t* outp = (const uint64_t*)out_ptrs;
  const bool fp2 = g2 && !C::G2_OVER_FP;
  int deg = fp2 ? 2 : 1;
  int n_in = deg * (op == 0 ? 6 : 5);
  for (int k = 0; k < n_in; k++) a.in[k] = (const uint32_t*)ip[k];
  for (int k = 0; k < 3 * deg; k++) a.out[k] = (uint32_t*)outp[k];
  a.inf = op == 1 ? (const uint8_t*)inf : nullptr;
  const uint32_t* b = (const uint32_t*)b3_host;
  for (int k = 0; k < deg * N; k++) a.b3[k] = b[k];
  if constexpr (!C::G2_OVER_FP) {
    if (fp2) {
      if (op == 0)
        k_add<G2F<C>><<<ts_blocks(n, THREADS_G2), THREADS_G2, 0, st>>>(a, n);
      else
        k_add_mixed<G2F<C>><<<ts_blocks(n, THREADS_G2), THREADS_G2, 0, st>>>(a, n);
      return (int)cudaGetLastError();
    }
  }
  constexpr int threads = N > INLINE_MUL_WORDS ? THREADS_G2 : THREADS_G1;
  if (op == 0)
    k_add<G1F<C>><<<ts_blocks(n, threads), threads, 0, st>>>(a, n);
  else
    k_add_mixed<G1F<C>><<<ts_blocks(n, threads), threads, 0, st>>>(a, n);
  return (int)cudaGetLastError();
}

}  // namespace ts
