// Complete projective group law for BN254 G1 (over Fp) and G2 (over Fp2),
// one point per thread.
//
// Replaces the TPU kernels
//   B5  tpusnark/curves/jcurve.py FusedCurveOps.add_mixed  (RCB15 alg. 8)
//   B6  tpusnark/curves/jcurve.py FusedCurveOps.add        (RCB15 alg. 7)
// over FpArith (G1, 3b = 9 as an add chain) and Fp2Arith (G2, 3b' passed in
// Montgomery form). The formulas run in the same order as jcurve.CurveOps,
// so the projective outputs equal tpusnark's coordinate by coordinate.
//
// Bound on the H100: integer multiply throughput. A G1 add is 12 Montgomery
// products (~1,600 32-bit multiply-adds) against 288 bytes of traffic; a G2
// add triples the products. One point per thread keeps the kernel simple;
// the strip loop that calls it once per row is later work to fuse.
#include "bn254.cuh"

using namespace bn254;

namespace {

struct CurveArgs {
  const uint32_t* in[12];  // coordinate components, (8, N) each
  uint32_t* out[6];
  const uint8_t* inf;  // add_mixed only: lanes that return the first operand
  Elt2 b3;             // G2 only: 3b' in Montgomery form
};

struct G1F {
  using E = Elt;
  __device__ static E add(const E& a, const E& b) { return bn254::add<FP>(a, b); }
  __device__ static E sub(const E& a, const E& b) { return bn254::sub<FP>(a, b); }
  __device__ static E mul(const E& a, const E& b) { return bn254::mul<FP>(a, b); }
  // 9x = 8x + x, as tpusnark's FpArith.mul_b3 for b = 3
  __device__ static E mul_b3(const E& x, const CurveArgs&) {
    E x2 = add(x, x);
    E x4 = add(x2, x2);
    E x8 = add(x4, x4);
    return add(x8, x);
  }
  __device__ static E ld(const uint32_t* const* p, int c, long n, long i) {
    return load(p[c], n, i);
  }
  __device__ static void st(uint32_t* const* p, int c, long n, long i, const E& v) {
    store(p[c], n, i, v);
  }
};

struct G2F {
  using E = Elt2;
  __device__ static E add(const E& a, const E& b) { return add2(a, b); }
  __device__ static E sub(const E& a, const E& b) { return sub2(a, b); }
  __device__ static E mul(const E& a, const E& b) { return mul2(a, b); }
  __device__ static E mul_b3(const E& x, const CurveArgs& args) { return mul2(x, args.b3); }
  __device__ static E ld(const uint32_t* const* p, int c, long n, long i) {
    return {load(p[2 * c], n, i), load(p[2 * c + 1], n, i)};
  }
  __device__ static void st(uint32_t* const* p, int c, long n, long i, const E& v) {
    store(p[2 * c], n, i, v.c0);
    store(p[2 * c + 1], n, i, v.c1);
  }
};

// RCB15 algorithm 7 (a = 0), in jcurve.CurveOps.add's order.
template <class F>
__global__ void k_add(CurveArgs args, long n) {
  using E = typename F::E;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  E X1 = F::ld(args.in, 0, n, i), Y1 = F::ld(args.in, 1, n, i), Z1 = F::ld(args.in, 2, n, i);
  E X2 = F::ld(args.in, 3, n, i), Y2 = F::ld(args.in, 4, n, i), Z2 = F::ld(args.in, 5, n, i);
  E t0 = F::mul(X1, X2);
  E t1 = F::mul(Y1, Y2);
  E t2 = F::mul(Z1, Z2);
  E m3 = F::mul(F::add(X1, Y1), F::add(X2, Y2));
  E m4 = F::mul(F::add(Y1, Z1), F::add(Y2, Z2));
  E m5 = F::mul(F::add(X1, Z1), F::add(X2, Z2));
  E t3 = F::sub(m3, F::add(t0, t1));
  E t4 = F::sub(m4, F::add(t1, t2));
  E y3p = F::sub(m5, F::add(t0, t2));
  E x3 = F::add(t0, t0);
  E t0n = F::add(x3, t0);
  E t2b = F::mul_b3(t2, args);
  E y3b = F::mul_b3(y3p, args);
  E z3 = F::add(t1, t2b);
  E t1n = F::sub(t1, t2b);
  E r0 = F::mul(t4, y3b);
  E r1 = F::mul(t3, t1n);
  E r2 = F::mul(y3b, t0n);
  E r3 = F::mul(t1n, z3);
  E r4 = F::mul(t0n, t3);
  E r5 = F::mul(z3, t4);
  F::st(args.out, 0, n, i, F::sub(r1, r0));
  F::st(args.out, 1, n, i, F::add(r3, r2));
  F::st(args.out, 2, n, i, F::add(r5, r4));
}

// RCB15 algorithm 8 (a = 0, Z2 = 1), in jcurve.CurveOps.add_mixed's order.
template <class F>
__global__ void k_add_mixed(CurveArgs args, long n) {
  using E = typename F::E;
  long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  E X1 = F::ld(args.in, 0, n, i), Y1 = F::ld(args.in, 1, n, i), Z1 = F::ld(args.in, 2, n, i);
  if (args.inf != nullptr && args.inf[i]) {
    F::st(args.out, 0, n, i, X1);
    F::st(args.out, 1, n, i, Y1);
    F::st(args.out, 2, n, i, Z1);
    return;
  }
  E X2 = F::ld(args.in, 3, n, i), Y2 = F::ld(args.in, 4, n, i);
  E t0 = F::mul(X1, X2);
  E t1 = F::mul(Y1, Y2);
  E m3 = F::mul(F::add(X1, Y1), F::add(X2, Y2));
  E mt4 = F::mul(X2, Z1);
  E mt5 = F::mul(Y2, Z1);
  E t3 = F::sub(m3, F::add(t0, t1));
  E t4 = F::add(mt4, X1);
  E t5 = F::add(mt5, Y1);
  E z3b = F::mul_b3(Z1, args);
  E y3b = F::mul_b3(t4, args);
  E x3 = F::add(t0, t0);
  E t0n = F::add(x3, t0);
  E z3 = F::add(t1, z3b);
  E t1n = F::sub(t1, z3b);
  E r0 = F::mul(t5, y3b);
  E r1 = F::mul(t3, t1n);
  E r2 = F::mul(y3b, t0n);
  E r3 = F::mul(t1n, z3);
  E r4 = F::mul(t0n, t3);
  E r5 = F::mul(z3, t5);
  F::st(args.out, 0, n, i, F::sub(r1, r0));
  F::st(args.out, 1, n, i, F::add(r3, r2));
  F::st(args.out, 2, n, i, F::add(r5, r4));
}

CurveArgs make_args(int g2, const void* in_ptrs, int n_in, const void* out_ptrs,
                    const void* inf, const void* b3_host) {
  CurveArgs a = {};
  const uint64_t* ip = (const uint64_t*)in_ptrs;
  const uint64_t* op = (const uint64_t*)out_ptrs;
  for (int k = 0; k < n_in; k++) a.in[k] = (const uint32_t*)ip[k];
  for (int k = 0; k < (g2 ? 6 : 3); k++) a.out[k] = (uint32_t*)op[k];
  a.inf = (const uint8_t*)inf;
  if (g2) {
    const uint32_t* b = (const uint32_t*)b3_host;
    for (int k = 0; k < 8; k++) {
      a.b3.c0.w[k] = b[k];
      a.b3.c1.w[k] = b[8 + k];
    }
  }
  return a;
}

constexpr int THREADS_G1 = 256;
constexpr int THREADS_G2 = 128;

}  // namespace

// in_ptrs/out_ptrs: host arrays of device pointers, one per coordinate
// component (G1: X, Y, Z; G2: X.c0, X.c1, Y.c0, ...). b3_host: 16 words of
// 3b' (c0 then c1) for G2, ignored for G1.
TS_EXPORT int ts_curve_add(int g2, const void* in_ptrs, const void* out_ptrs,
                           const void* b3_host, long n, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  CurveArgs a = make_args(g2, in_ptrs, g2 ? 12 : 6, out_ptrs, nullptr, b3_host);
  if (g2)
    k_add<G2F><<<ts_blocks(n, THREADS_G2), THREADS_G2, 0, st>>>(a, n);
  else
    k_add<G1F><<<ts_blocks(n, THREADS_G1), THREADS_G1, 0, st>>>(a, n);
  return (int)cudaGetLastError();
}

// inf: (N,) bytes or null; lanes with inf[i] != 0 return the first operand.
TS_EXPORT int ts_curve_add_mixed(int g2, const void* in_ptrs, const void* out_ptrs,
                                 const void* inf, const void* b3_host, long n,
                                 void* stream) {
  if (n <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  CurveArgs a = make_args(g2, in_ptrs, g2 ? 10 : 5, out_ptrs, inf, b3_host);
  if (g2)
    k_add_mixed<G2F><<<ts_blocks(n, THREADS_G2), THREADS_G2, 0, st>>>(a, n);
  else
    k_add_mixed<G1F><<<ts_blocks(n, THREADS_G1), THREADS_G1, 0, st>>>(a, n);
  return (int)cudaGetLastError();
}
