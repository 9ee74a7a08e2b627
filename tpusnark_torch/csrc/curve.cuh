// Complete projective group law for G1 (over Fp) and G2 (over Fp2 =
// Fp[u]/(u^2 + Q), or over Fp itself for BW6-761's sextic twist) of one
// curve, one point per thread. Each curve_<name>.cu instantiates it for one
// curve, so the curves build in parallel. The group-law bodies are device
// functions of the group (padd, padd_mixed): the pointwise kernels here and
// the fused MSM kernels of msm.cuh run the same formulas.
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
// An Fp2 element is 2N registers (24 at 12 words), so the G2 kernels sit at
// 255 registers and spill: at 12 words their Fp2 product is a call
// (mul2_called), as the 24-word Fp product of BW6-761 is (mont.cuh). The
// pointwise kernels keep one point per thread; the MSM runs its loops
// through msm.cuh, so these serve setup's fixed-base multiplication and the
// few adds the MSM has left.
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

// A field constant in the launch arguments, Montgomery form: N words over
// Fp, or c0 then c1 (2N words) over Fp2.
struct Const {
  uint32_t w[2 * MAX_WORDS];
};

struct CurveArgs {
  const uint32_t* in[12];  // coordinate components, (N, lanes) each
  uint32_t* out[6];
  const uint8_t* inf;  // add_mixed only: lanes that return the first operand
  Const b3;            // 3b (over Fp) or 3b' (over Fp2)
};

// The curves with kernels: BN254 (G1 3b = 9, the add chain), BLS12-381 and
// BLS12-377 (3b a Montgomery product; Fp2 with u^2 = -1 and u^2 = -5), and
// BW6-761, whose G2 is the sextic twist over Fp itself (no Fp2).
using BN254 = Curve<BN254_FP, 1, true>;
using BLS12_381 = Curve<BLS12_381_FP, 1, false>;
using BLS12_377 = Curve<BLS12_377_FP, 5, false>;
using BW6_761 = Curve<BW6_761_FP, 1, false, true>;

// CALLED: the Fp product is a call at every width (mont.cuh calls it above
// 12 words anyway): for kernels whose time is a launch's, not the products'.
template <class C, bool CALLED = false>
struct G1F {
  static constexpr int F = C::FP;
  static constexpr int N = words_of(F);
  static constexpr int COMPONENTS = 1;  // Fp elements per coordinate
  using E = EltOf<F>;
  __device__ static E add(const E& a, const E& b) { return ts::add<F>(a, b); }
  __device__ static E sub(const E& a, const E& b) { return ts::sub<F>(a, b); }
  __device__ static E mul(const E& a, const E& b) {
    if constexpr (CALLED)
      return mul_called<F>(a, b);
    else
      return ts::mul<F>(a, b);
  }
  __device__ static E neg(const E& a) { return ts::neg<F>(a); }
  __device__ static E zero() { return ts::zero<N>(); }
  __device__ static E cst(const Const& c) {
    E r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = c.w[k];
    return r;
  }
  __device__ static E mul_b3(const E& x, const Const& b3) {
    if constexpr (C::G1_B3_IS_9) {  // 9x = 8x + x
      E x2 = add(x, x);
      E x4 = add(x2, x2);
      E x8 = add(x4, x4);
      return add(x8, x);
    } else {
      return mul(x, cst(b3));
    }
  }
  __device__ static E ld(const uint32_t* const* p, int c, long n, long i) {
    return load<N>(p[c], n, i);
  }
  __device__ static void st(uint32_t* const* p, int c, long n, long i, const E& v) {
    store<N>(p[c], n, i, v);
  }
  // component c of point i of a strided image: word k at p[c][k * sw + i * sp]
  __device__ static E ld_strided(const uint32_t* const* p, int c, long sw, long sp, long i) {
    E r;
#pragma unroll
    for (int k = 0; k < N; k++) r.w[k] = p[c][k * sw + i * sp];
    return r;
  }
};

// The Fp2 product as one function that its callers call (as mul_called is
// for a wide Fp product): a kernel that loops over points and keeps an
// accumulator alive cannot hold 14 inlined products of three 12-word
// Montgomery products each in 255 registers, and takes ptxas a minute.
template <int F, int Q>
__device__ __noinline__ Elt2<F> mul2_called(const Elt2<F>& a, const Elt2<F>& b) {
  return mul2<F, Q>(a, b);
}

// CALLED: the Fp2 product is a call (the fused MSM kernels at 12 words).
template <class C, bool CALLED = false>
struct G2F {
  static constexpr int F = C::FP;
  static constexpr int N = words_of(F);
  static constexpr int COMPONENTS = 2;
  using E = Elt2<F>;
  __device__ static E add(const E& a, const E& b) { return add2<F>(a, b); }
  __device__ static E sub(const E& a, const E& b) { return sub2<F>(a, b); }
  __device__ static E mul(const E& a, const E& b) {
    if constexpr (CALLED)
      return mul2_called<F, C::Q>(a, b);
    else
      return mul2<F, C::Q>(a, b);
  }
  __device__ static E neg(const E& a) { return {ts::neg<F>(a.c0), ts::neg<F>(a.c1)}; }
  __device__ static E zero() { return {ts::zero<N>(), ts::zero<N>()}; }
  __device__ static E cst(const Const& c) {
    E r;
#pragma unroll
    for (int k = 0; k < N; k++) {
      r.c0.w[k] = c.w[k];
      r.c1.w[k] = c.w[N + k];
    }
    return r;
  }
  __device__ static E mul_b3(const E& x, const Const& b3) { return mul(x, cst(b3)); }
  __device__ static E ld(const uint32_t* const* p, int c, long n, long i) {
    return {load<N>(p[2 * c], n, i), load<N>(p[2 * c + 1], n, i)};
  }
  __device__ static void st(uint32_t* const* p, int c, long n, long i, const E& v) {
    store<N>(p[2 * c], n, i, v.c0);
    store<N>(p[2 * c + 1], n, i, v.c1);
  }
  __device__ static E ld_strided(const uint32_t* const* p, int c, long sw, long sp, long i) {
    E r;
#pragma unroll
    for (int k = 0; k < N; k++) {
      r.c0.w[k] = p[2 * c][k * sw + i * sp];
      r.c1.w[k] = p[2 * c + 1][k * sw + i * sp];
    }
    return r;
  }
};

// G2 over Fp2 as the kernels run it: at 12 words the Fp2 product is a call.
// (Inlined, the pointwise kernels spilled 1.1-2 KB a thread, ran at half the
// rate per add of the loop kernels that call it, and took ptxas a minute.)
template <class C>
using G2M = G2F<C, (words_of(C::FP) >= 12)>;

// A projective point of group G in registers.
template <class G>
struct Proj {
  typename G::E X, Y, Z;
};

template <class G>
__device__ __forceinline__ Proj<G> ld_pt(const uint32_t* const* p, long n, long i) {
  return {G::ld(p, 0, n, i), G::ld(p, 1, n, i), G::ld(p, 2, n, i)};
}

template <class G>
__device__ __forceinline__ void st_pt(uint32_t* const* p, long n, long i, const Proj<G>& v) {
  G::st(p, 0, n, i, v.X);
  G::st(p, 1, n, i, v.Y);
  G::st(p, 2, n, i, v.Z);
}

// RCB15 algorithm 7 (a = 0), in jcurve.CurveOps.add's order.
template <class G>
__device__ __forceinline__ Proj<G> padd(const Proj<G>& p, const Proj<G>& q, const Const& b3) {
  using E = typename G::E;
  E t0 = G::mul(p.X, q.X);
  E t1 = G::mul(p.Y, q.Y);
  E t2 = G::mul(p.Z, q.Z);
  E m3 = G::mul(G::add(p.X, p.Y), G::add(q.X, q.Y));
  E m4 = G::mul(G::add(p.Y, p.Z), G::add(q.Y, q.Z));
  E m5 = G::mul(G::add(p.X, p.Z), G::add(q.X, q.Z));
  E t3 = G::sub(m3, G::add(t0, t1));
  E t4 = G::sub(m4, G::add(t1, t2));
  E y3p = G::sub(m5, G::add(t0, t2));
  E x3 = G::add(t0, t0);
  E t0n = G::add(x3, t0);
  E t2b = G::mul_b3(t2, b3);
  E y3b = G::mul_b3(y3p, b3);
  E z3 = G::add(t1, t2b);
  E t1n = G::sub(t1, t2b);
  E r0 = G::mul(t4, y3b);
  E r1 = G::mul(t3, t1n);
  E r2 = G::mul(y3b, t0n);
  E r3 = G::mul(t1n, z3);
  E r4 = G::mul(t0n, t3);
  E r5 = G::mul(z3, t4);
  return {G::sub(r1, r0), G::add(r3, r2), G::add(r5, r4)};
}

// RCB15 algorithm 8 (a = 0, Z2 = 1), in jcurve.CurveOps.add_mixed's order.
template <class G>
__device__ __forceinline__ Proj<G> padd_mixed(const Proj<G>& p, const typename G::E& X2,
                                              const typename G::E& Y2, const Const& b3) {
  using E = typename G::E;
  E t0 = G::mul(p.X, X2);
  E t1 = G::mul(p.Y, Y2);
  E m3 = G::mul(G::add(p.X, p.Y), G::add(X2, Y2));
  E mt4 = G::mul(X2, p.Z);
  E mt5 = G::mul(Y2, p.Z);
  E t3 = G::sub(m3, G::add(t0, t1));
  E t4 = G::add(mt4, p.X);
  E t5 = G::add(mt5, p.Y);
  E z3b = G::mul_b3(p.Z, b3);
  E y3b = G::mul_b3(t4, b3);
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
  return {G::sub(r1, r0), G::add(r3, r2), G::add(r5, r4)};
}

// B6, pointwise: one complete add per thread.
template <class G>
__global__ void k_add(CurveArgs args, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj<G> p = ld_pt<G>(args.in, n, i);
  Proj<G> q = ld_pt<G>(args.in + 3 * G::COMPONENTS, n, i);
  st_pt<G>(args.out, n, i, padd<G>(p, q, args.b3));
}

// B5, pointwise: one complete mixed add per thread; infinity lanes copy.
template <class G>
__global__ void k_add_mixed(CurveArgs args, long n) {
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Proj<G> p = ld_pt<G>(args.in, n, i);
  if (args.inf != nullptr && args.inf[i]) {
    st_pt<G>(args.out, n, i, p);
    return;
  }
  typename G::E X2 = G::ld(args.in, 3, n, i), Y2 = G::ld(args.in, 4, n, i);
  st_pt<G>(args.out, n, i, padd_mixed<G>(p, X2, Y2, args.b3));
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
  for (int k = 0; k < deg * N; k++) a.b3.w[k] = b[k];
  if constexpr (!C::G2_OVER_FP) {
    if (fp2) {
      if (op == 0)
        k_add<G2M<C>><<<ts_blocks(n, THREADS_G2), THREADS_G2, 0, st>>>(a, n);
      else
        k_add_mixed<G2M<C>><<<ts_blocks(n, THREADS_G2), THREADS_G2, 0, st>>>(a, n);
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
