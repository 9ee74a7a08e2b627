// Montgomery field arithmetic over N 32-bit words, shared by every kernel
// of the port. One template serves every field; the field id F (a
// compile-time parameter) picks the word count and the constants.
//
// Elements are N little-endian 32-bit words in Montgomery form with
// R = 2^(32 N), stored limb-major: word w of lane i of an (N, lanes) tensor
// sits at ptr[w * lanes + i], so consecutive threads read consecutive words.
// N is ceil(n_limbs / 2) of the field's FieldSpec: 8 for BN254 fr and fp, 9
// for BLS12-381 fr, 12 for BLS12-381 fp.
//
// The lazy-range contract is tpusnark's (fields/jfield.py): inputs and
// outputs of mul/add/sub lie in [0, 2p). It is sound because 4p < R for
// every field here: a*b < 4p^2 < R*p, so (a*b + m*p)/R < 2p without a final
// subtraction. CIOS with 32-bit words computes the same (T + m*p)/R as a
// full-word Montgomery product (m is the unique value < R that makes the sum
// divisible by R), so results agree word for word with the plain versions.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ts {

constexpr int MAX_WORDS = 12;

// field ids: the index into MODS and the `field` argument of the entry points
enum FieldId { BN254_FR = 0, BN254_FP = 1, BLS12_381_FR = 2, BLS12_381_FP = 3 };

__host__ __device__ constexpr int words_of(int f) {
  return f == BLS12_381_FR ? 9 : f == BLS12_381_FP ? 12 : 8;
}

struct Mod {
  uint32_t p[MAX_WORDS];   // p, little-endian, zero-padded to MAX_WORDS
  uint32_t p2[MAX_WORDS];  // 2p
  uint32_t inv;            // -p^-1 mod 2^32
};

// One entry per field id; tests/test_torch_field.py checks every value
// against the FieldSpec of the same name.
static __constant__ Mod MODS[4] = {
    // field 0: bn254_fr, 8 words
    {{0xf0000001u, 0x43e1f593u, 0x79b97091u, 0x2833e848u, 0x8181585du,
      0xb85045b6u, 0xe131a029u, 0x30644e72u},
     {0xe0000002u, 0x87c3eb27u, 0xf372e122u, 0x5067d090u, 0x0302b0bau,
      0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
     0xefffffffu},
    // field 1: bn254_fp, 8 words
    {{0xd87cfd47u, 0x3c208c16u, 0x6871ca8du, 0x97816a91u, 0x8181585du,
      0xb85045b6u, 0xe131a029u, 0x30644e72u},
     {0xb0f9fa8eu, 0x7841182du, 0xd0e3951au, 0x2f02d522u, 0x0302b0bbu,
      0x70a08b6du, 0xc2634053u, 0x60c89ce5u},
     0xe4866389u},
    // field 2: bls12_381_fr, 9 words
    {{0x00000001u, 0xffffffffu, 0xfffe5bfeu, 0x53bda402u, 0x09a1d805u,
      0x3339d808u, 0x299d7d48u, 0x73eda753u, 0x00000000u},
     {0x00000002u, 0xfffffffeu, 0xfffcb7fdu, 0xa77b4805u, 0x1343b00au,
      0x6673b010u, 0x533afa90u, 0xe7db4ea6u, 0x00000000u},
     0xffffffffu},
    // field 3: bls12_381_fp, 12 words
    {{0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,
      0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,
      0x397fe69au, 0x1a0111eau},
     {0xffff5556u, 0x73fdffffu, 0x62a7ffffu, 0x3d57fffdu, 0xed61ec48u,
      0xce61a541u, 0xe70a257eu, 0xc8ee9709u, 0x869759aeu, 0x96374f6cu,
      0x72ffcd34u, 0x340223d4u},
     0xfffcfffdu},
};

template <int N>
struct Elt {
  uint32_t w[N];
};

template <int F>
using EltOf = Elt<words_of(F)>;

template <int N>
__device__ __forceinline__ Elt<N> load(const uint32_t* __restrict__ p, long n, long i) {
  Elt<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = p[k * n + i];
  return r;
}

template <int N>
__device__ __forceinline__ void store(uint32_t* __restrict__ p, long n, long i, const Elt<N>& a) {
#pragma unroll
  for (int k = 0; k < N; k++) p[k * n + i] = a.w[k];
}

template <int N>
__device__ __forceinline__ Elt<N> zero() {
  Elt<N> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = 0;
  return r;
}

// Montgomery product a*b*R^-1, CIOS over 32-bit words.
template <int F>
__device__ __forceinline__ EltOf<F> mul(const EltOf<F>& a, const EltOf<F>& b) {
  constexpr int N = words_of(F);
  const Mod& M = MODS[F];
  uint32_t t[N + 2];
#pragma unroll
  for (int k = 0; k < N + 2; k++) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; i++) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < N; j++) {
      uint64_t s = (uint64_t)t[j] + (uint64_t)a.w[j] * b.w[i] + c;
      t[j] = (uint32_t)s;
      c = s >> 32;
    }
    uint64_t s = (uint64_t)t[N] + c;
    t[N] = (uint32_t)s;
    t[N + 1] = (uint32_t)(s >> 32);
    uint32_t m = t[0] * M.inv;
    s = (uint64_t)t[0] + (uint64_t)m * M.p[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)t[j] + (uint64_t)m * M.p[j] + c;
      t[j - 1] = (uint32_t)s;
      c = s >> 32;
    }
    s = (uint64_t)t[N] + c;
    t[N - 1] = (uint32_t)s;
    t[N] = t[N + 1] + (uint32_t)(s >> 32);
  }
  EltOf<F> r;
#pragma unroll
  for (int k = 0; k < N; k++) r.w[k] = t[k];
  return r;
}

// a + b, reduced by 2p when the sum reaches 2p (a, b < 2p; sum < 4p < R).
template <int F>
__device__ __forceinline__ EltOf<F> add(const EltOf<F>& a, const EltOf<F>& b) {
  constexpr int N = words_of(F);
  const Mod& M = MODS[F];
  EltOf<F> s, d;
  uint64_t c = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    uint64_t v = (uint64_t)a.w[k] + b.w[k] + c;
    s.w[k] = (uint32_t)v;
    c = v >> 32;
  }
  int64_t br = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    int64_t v = (int64_t)s.w[k] - M.p2[k] + br;
    d.w[k] = (uint32_t)v;
    br = v >> 32;  // 0 or -1
  }
  return br ? s : d;
}

// a - b, plus 2p when it borrows (a, b < 2p).
template <int F>
__device__ __forceinline__ EltOf<F> sub(const EltOf<F>& a, const EltOf<F>& b) {
  constexpr int N = words_of(F);
  const Mod& M = MODS[F];
  EltOf<F> d;
  int64_t br = 0;
#pragma unroll
  for (int k = 0; k < N; k++) {
    int64_t v = (int64_t)a.w[k] - b.w[k] + br;
    d.w[k] = (uint32_t)v;
    br = v >> 32;
  }
  if (br) {
    uint64_t c = 0;
#pragma unroll
    for (int k = 0; k < N; k++) {
      uint64_t v = (uint64_t)d.w[k] + M.p2[k] + c;
      d.w[k] = (uint32_t)v;
      c = v >> 32;
    }
  }
  return d;
}

template <int F>
__device__ __forceinline__ EltOf<F> neg(const EltOf<F>& a) {
  return sub<F>(zero<words_of(F)>(), a);
}

// k * x for a small compile-time k by lazy double-and-add, in the order of
// tpusnark's jcurve._small_mul (k = 1 is x itself).
template <int F, int K>
__device__ __forceinline__ EltOf<F> small_mul(const EltOf<F>& x) {
  static_assert(K >= 1 && K <= 16, "small constant expected");
  EltOf<F> acc = x, addend = x;
  bool have = false;
  int kk = K;
#pragma unroll
  for (int bit = 0; bit < 5; bit++) {
    if (kk == 0) break;
    if (kk & 1) {
      acc = have ? add<F>(acc, addend) : addend;
      have = true;
    }
    kk >>= 1;
    if (kk) addend = add<F>(addend, addend);
  }
  return acc;
}

// ---- Fp2 = Fp[u]/(u^2 + Q): tpusnark's Fp2Arith ----------------------------
template <int F>
struct Elt2 {
  EltOf<F> c0, c1;
};

template <int F>
__device__ __forceinline__ Elt2<F> add2(const Elt2<F>& a, const Elt2<F>& b) {
  return {add<F>(a.c0, b.c0), add<F>(a.c1, b.c1)};
}

template <int F>
__device__ __forceinline__ Elt2<F> sub2(const Elt2<F>& a, const Elt2<F>& b) {
  return {sub<F>(a.c0, b.c0), sub<F>(a.c1, b.c1)};
}

// Karatsuba in tpusnark's order (jcurve.py Fp2Arith.mul_many):
// c0 = a0*b0 - Q*a1*b1, c1 = (a0+a1)(b0+b1) - (a0*b0 + a1*b1).
template <int F, int Q>
__device__ __forceinline__ Elt2<F> mul2(const Elt2<F>& a, const Elt2<F>& b) {
  EltOf<F> asum = add<F>(a.c0, a.c1);
  EltOf<F> bsum = add<F>(b.c0, b.c1);
  EltOf<F> t0 = mul<F>(a.c0, b.c0);
  EltOf<F> t1 = mul<F>(a.c1, b.c1);
  EltOf<F> t2 = mul<F>(asum, bsum);
  return {sub<F>(t0, small_mul<F, Q>(t1)), sub<F>(t2, add<F>(t0, t1))};
}

}  // namespace ts

// Every entry point returns cudaGetLastError() as an int (or
// cudaErrorInvalidValue for a field or curve id it does not serve), and
// launches on the stream it is given; outputs are allocated by the caller.
#define TS_EXPORT extern "C" __attribute__((visibility("default")))

static inline int ts_blocks(long n, int threads) { return (int)((n + threads - 1) / threads); }
