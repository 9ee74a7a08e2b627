// BN254 field arithmetic shared by every kernel of the port.
//
// Elements are eight little-endian 32-bit words in Montgomery form with
// R = 2^256, stored limb-major: word w of lane i of an (8, N) tensor sits at
// ptr[w * N + i], so consecutive threads read consecutive words.
//
// The lazy-range contract is tpusnark's (fields/jfield.py): inputs and
// outputs of mul/add/sub lie in [0, 2p). It is sound because 4p < 2^256:
// a*b < 4p^2 < R*p, so (a*b + m*p)/R < 2p without a final subtraction.
// CIOS with 32-bit words computes the same (T + m*p)/R as tpusnark's
// full-word Montgomery product (m is the unique value < R that makes the sum
// divisible by R), so results agree word for word.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace bn254 {

struct Mod {
  uint32_t p[8];
  uint32_t p2[8];
  uint32_t inv;  // -p^-1 mod 2^32
};

enum { FR = 0, FP = 1 };

// index 0: the scalar field fr; index 1: the base field fp
static __constant__ Mod MODS[2] = {
    {{0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
      0xb85045b6u, 0xe131a029u, 0x30644e72u},
     {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u, 0x0302b0bau,
      0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
     0xefffffffu},
    {{0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
      0xb85045b6u, 0xe131a029u, 0x30644e72u},
     {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u, 0x0302b0bbu,
      0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
     0xe4866389u},
};

struct Elt {
  uint32_t w[8];
};

__device__ __forceinline__ Elt load(const uint32_t* __restrict__ p, long n, long i) {
  Elt r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = p[k * n + i];
  return r;
}

__device__ __forceinline__ void store(uint32_t* __restrict__ p, long n, long i, const Elt& a) {
#pragma unroll
  for (int k = 0; k < 8; k++) p[k * n + i] = a.w[k];
}

__device__ __forceinline__ Elt zero() {
  Elt r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = 0;
  return r;
}

// Montgomery product a*b*R^-1, CIOS over 32-bit words.
template <int S>
__device__ __forceinline__ Elt mul(const Elt& a, const Elt& b) {
  const Mod& M = MODS[S];
  uint32_t t[10];
#pragma unroll
  for (int k = 0; k < 10; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < 8; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < 8; j++) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[8] + c;
    t[8] = (uint32_t)s;
    t[9] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * M.inv;
    s = (uint64_t)t[0] + (uint64_t)m * M.p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < 8; j++) {
      s = (uint64_t)t[j] + (uint64_t)m * M.p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[8] + c;
    t[7] = (uint32_t)s;
    t[8] = t[9] + (uint32_t)(s >> 32);
  }
  Elt r;
#pragma unroll
  for (int k = 0; k < 8; k++) r.w[k] = t[k];
  return r;
}

// a + b, reduced by 2p when the sum reaches 2p (a, b < 2p; sum < 4p < 2^256).
template <int S>
__device__ __forceinline__ Elt add(const Elt& a, const Elt& b) {
  const Mod& M = MODS[S];
  Elt s, d;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    uint64_t v = (uint64_t)a.w[k] + b.w[k] + c;
    s.w[k] = (uint32_t)v;
    c = v >> 32;
  }
  int64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    int64_t v = (int64_t)s.w[k] - M.p2[k] + br;
    d.w[k] = (uint32_t)v;
    br = v >> 32;  // 0 or -1
  }
  return br ? s : d;
}

// a - b, plus 2p when it borrows (a, b < 2p).
template <int S>
__device__ __forceinline__ Elt sub(const Elt& a, const Elt& b) {
  const Mod& M = MODS[S];
  Elt d;
  int64_t br = 0;
#pragma unroll
  for (int k = 0; k < 8; k++) {
    int64_t v = (int64_t)a.w[k] - b.w[k] + br;
    d.w[k] = (uint32_t)v;
    br = v >> 32;
  }
  if (br) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < 8; k++) {
      uint64_t v = (uint64_t)d.w[k] + M.p2[k] + c;
      d.w[k] = (uint32_t)v;
      c = v >> 32;
    }
  }
  return d;
}

template <int S>
__device__ __forceinline__ Elt neg(const Elt& a) {
  return sub<S>(zero(), a);
}

// ---- Fp2 = Fp[u]/(u^2 + 1): tpusnark's Fp2Arith with q = 1 ----------------
struct Elt2 {
  Elt c0, c1;
};

__device__ __forceinline__ Elt2 add2(const Elt2& a, const Elt2& b) {
  return {add<FP>(a.c0, b.c0), add<FP>(a.c1, b.c1)};
}

__device__ __forceinline__ Elt2 sub2(const Elt2& a, const Elt2& b) {
  return {sub<FP>(a.c0, b.c0), sub<FP>(a.c1, b.c1)};
}

// Karatsuba in tpusnark's order (jcurve.py Fp2Arith.mul_many):
// c0 = a0*b0 - a1*b1, c1 = (a0+a1)(b0+b1) - (a0*b0 + a1*b1).
__device__ __forceinline__ Elt2 mul2(const Elt2& a, const Elt2& b) {
  Elt asum = add<FP>(a.c0, a.c1);
  Elt bsum = add<FP>(b.c0, b.c1);
  Elt t0 = mul<FP>(a.c0, b.c0);
  Elt t1 = mul<FP>(a.c1, b.c1);
  Elt t2 = mul<FP>(asum, bsum);
  return {sub<FP>(t0, t1), sub<FP>(t2, add<FP>(t0, t1))};
}

}  // namespace bn254

// Every entry point returns cudaGetLastError() as an int, and launches on the
// stream it is given; outputs are allocated by the caller.
#define TS_EXPORT extern "C" __attribute__((visibility("default")))

static inline int ts_blocks(long n, int threads) { return (int)((n + threads - 1) / threads); }
