// Montgomery field arithmetic over N 32-bit words, shared by every kernel
// of the port. One template serves every field; the field id F (a
// compile-time parameter) picks the word count and the constants.
//
// Elements are N little-endian 32-bit words in Montgomery form with
// R = 2^(32 N), stored limb-major: word w of lane i of an (N, lanes) tensor
// sits at ptr[w * lanes + i], so consecutive threads read consecutive words.
// N is ceil(n_limbs / 2) of the field's FieldSpec: 8 for BN254 fr and fp,
// BLS12-377 fr and BLS24-315 fr, 9 for BLS12-381 fr and BLS24-317 fr, 10
// for BLS24-315 fp, BLS24-317 fp and BW6-633 fr (the same modulus as
// BLS24-315 fp: the 2-chain), 12 for BLS12-381 fp, BLS12-377 fp and BW6-761
// fr (the same modulus: the 2-chain), 20 for BW6-633 fp, 24 for BW6-761 fp.
//
// The lazy-range contract is tpusnark's (fields/jfield.py): inputs and
// outputs of mul/add/sub lie in [0, 2p). It is sound because 4p < R for
// every field here: a*b < 4p^2 < R*p, so (a*b + m*p)/R < 2p without a final
// subtraction. The product is CIOS (one word of b a row, then one word of
// reduction) on the card's integer carry chains (PTX mad.lo.cc / madc.hi.cc /
// addc); it computes the same (T + m*p)/R as a full-word Montgomery product
// (m is the unique value < R that makes the sum divisible by R), so results
// agree word for word with the plain versions. The moduli are compile-time
// constants, so p, 2p and -p^-1 enter the multiply-adds as immediates.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>
#include <type_traits>
#include <utility>

namespace ts {

constexpr int MAX_WORDS = 24;

// field ids: the index into MODS and the `field` argument of the entry points
enum FieldId {
  BN254_FR = 0,
  BN254_FP = 1,
  BLS12_381_FR = 2,
  BLS12_381_FP = 3,
  BLS12_377_FR = 4,
  BLS12_377_FP = 5,
  BW6_761_FR = 6,
  BW6_761_FP = 7,
  BLS24_315_FR = 8,
  BLS24_315_FP = 9,
  BLS24_317_FR = 10,
  BLS24_317_FP = 11,
  BW6_633_FR = 12,
  BW6_633_FP = 13
};

constexpr int N_FIELDS = 14;

__host__ __device__ constexpr int words_of(int f) {
  return f == BLS12_381_FR ? 9 : f == BLS12_381_FP ? 12 : f == BLS12_377_FP ? 12 : f == BW6_761_FR ? 12
       : f == BW6_761_FP ? 24 : f == BLS24_315_FP ? 10 : f == BLS24_317_FR ? 9 : f == BLS24_317_FP ? 10
       : f == BW6_633_FR ? 10 : f == BW6_633_FP ? 20 : 8;
}

struct Mod {
  uint32_t p[MAX_WORDS];   // p, little-endian, zero-padded to MAX_WORDS
  uint32_t p2[MAX_WORDS];  // 2p
  uint32_t inv;            // -p^-1 mod 2^32
};

// One entry per field id; tests/test_torch_field.py checks every value
// against the FieldSpec of the same name. Device code reads it only through
// p_word, p2_word and inv_of in constant expressions (nvcc keeps a constexpr
// table on the host and folds its words into the instructions).
constexpr Mod MODS[N_FIELDS] = {
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
    // field 4: bls12_377_fr, 8 words
    {{0x00000001u, 0x0a118000u, 0xd0000001u, 0x59aa76feu, 0x5c37b001u,
      0x60b44d1eu, 0x9a2ca556u, 0x12ab655eu},
     {0x00000002u, 0x14230000u, 0xa0000002u, 0xb354edfdu, 0xb86f6002u,
      0xc1689a3cu, 0x34594aacu, 0x2556cabdu},
     0xffffffffu},
    // field 5: bls12_377_fp, 12 words
    {{0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u, 0xba094800u,
      0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu, 0xc63b05c0u,
      0x17c510eau, 0x01ae3a46u},
     {0x00000002u, 0x0a118000u, 0x60000001u, 0x2e16ba88u, 0x74129000u,
      0x3de6c45fu, 0x01ea271eu, 0x3445b3e6u, 0xd9429276u, 0x8c760b80u,
      0x2f8a21d5u, 0x035c748cu},
     0xffffffffu},
    // field 6: bw6_761_fr, 12 words
    {{0x00000001u, 0x8508c000u, 0x30000000u, 0x170b5d44u, 0xba094800u,
      0x1ef3622fu, 0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu, 0xc63b05c0u,
      0x17c510eau, 0x01ae3a46u},
     {0x00000002u, 0x0a118000u, 0x60000001u, 0x2e16ba88u, 0x74129000u,
      0x3de6c45fu, 0x01ea271eu, 0x3445b3e6u, 0xd9429276u, 0x8c760b80u,
      0x2f8a21d5u, 0x035c748cu},
     0xffffffffu},
    // field 7: bw6_761_fp, 24 words
    {{0x0000008bu, 0xf49d0000u, 0x70000082u, 0xe6913e68u, 0xeaf0a437u,
      0x160cf8aeu, 0x5667a8f8u, 0x98a116c2u, 0x73ebff2eu, 0x71dcd3dcu,
      0x12f9fd90u, 0x8689c8edu, 0x25b42304u, 0x03cebaffu, 0xe584e919u,
      0x707ba638u, 0x8087be41u, 0x528275efu, 0x81d14688u, 0xb926186au,
      0x04faff3eu, 0xd187c940u, 0xfb83ce0au, 0x0122e824u},
     {0x00000116u, 0xe93a0000u, 0xe0000105u, 0xcd227cd0u, 0xd5e1486fu,
      0x2c19f15du, 0xaccf51f0u, 0x31422d84u, 0xe7d7fe5du, 0xe3b9a7b8u,
      0x25f3fb20u, 0x0d1391dau, 0x4b684609u, 0x079d75feu, 0xcb09d232u,
      0xe0f74c71u, 0x010f7c82u, 0xa504ebdfu, 0x03a28d10u, 0x724c30d5u,
      0x09f5fe7du, 0xa30f9280u, 0xf7079c15u, 0x0245d049u},
     0x8fa798ddu},
    // field 8: bls24_315_fr, 8 words
    {{0x00c00001u, 0x19d0c5fdu, 0xe644e364u, 0xc8c480ecu, 0xcf927a98u,
      0x25fc7ec9u, 0x4a9da12bu, 0x196deac2u},
     {0x01800002u, 0x33a18bfau, 0xcc89c6c8u, 0x918901d9u, 0x9f24f531u,
      0x4bf8fd93u, 0x953b4256u, 0x32dbd584u},
     0x00bfffffu},
    // field 9: bls24_315_fp, 10 words
    {{0x40300001u, 0x6fe802ffu, 0x52bde502u, 0x421ee5dau, 0xa27a1ae0u,
      0xdec1d01au, 0xe97c5eafu, 0xd3f7498bu, 0xb586d650u, 0x04c23a02u},
     {0x80600002u, 0xdfd005feu, 0xa57bca04u, 0x843dcbb4u, 0x44f435c0u,
      0xbd83a035u, 0xd2f8bd5fu, 0xa7ee9317u, 0x6b0daca1u, 0x09847405u},
     0x402fffffu},
    // field 10: bls24_317_fr, 9 words
    {{0x00000001u, 0xf0000000u, 0x96bf0e7au, 0x1cd1e791u, 0x8d83cd49u,
      0xd0b097f2u, 0xa68dafc2u, 0x443f917eu, 0x00000000u},
     {0x00000002u, 0xe0000000u, 0x2d7e1cf5u, 0x39a3cf23u, 0x1b079a92u,
      0xa1612fe5u, 0x4d1b5f85u, 0x887f22fdu, 0x00000000u},
     0xffffffffu},
    // field 11: bls24_317_fp, 10 words
    {{0x5dab2aabu, 0x8d512e56u, 0x3424bf7eu, 0xd6f339e4u, 0x84c73446u,
      0x169a61e6u, 0xb7f9d039u, 0xf28fc5a0u, 0x6f60892cu, 0x1058ca22u},
     {0xbb565556u, 0x1aa25cacu, 0x68497efdu, 0xade673c8u, 0x098e688du,
      0x2d34c3cdu, 0x6ff3a072u, 0xe51f8b41u, 0xdec11259u, 0x20b19444u},
     0x8b047ffdu},
    // field 12: bw6_633_fr, 10 words
    {{0x40300001u, 0x6fe802ffu, 0x52bde502u, 0x421ee5dau, 0xa27a1ae0u,
      0xdec1d01au, 0xe97c5eafu, 0xd3f7498bu, 0xb586d650u, 0x04c23a02u},
     {0x80600002u, 0xdfd005feu, 0xa57bca04u, 0x843dcbb4u, 0x44f435c0u,
      0xbd83a035u, 0xd2f8bd5fu, 0xa7ee9317u, 0x6b0daca1u, 0x09847405u},
     0x402fffffu},
    // field 13: bw6_633_fp, 20 words
    {{0x4570000du, 0xd74916eau, 0x1147f73cu, 0x3d369bd3u, 0xb839c225u,
      0xd7b5ce7au, 0xedbda407u, 0x7e0e8850u, 0x83f57c49u, 0xb8da9f5eu,
      0xfadea490u, 0x8152a6c0u, 0xd9bbda2fu, 0x4e59769au, 0x5d79d2c7u,
      0xa8fcd8c7u, 0x01d72ab5u, 0xfc1a174fu, 0xc0f35f63u, 0x0126633cu},
     {0x8ae0001au, 0xae922dd4u, 0x228fee79u, 0x7a6d37a6u, 0x7073844au,
      0xaf6b9cf5u, 0xdb7b480fu, 0xfc1d10a1u, 0x07eaf892u, 0x71b53ebdu,
      0xf5bd4921u, 0x02a54d81u, 0xb377b45fu, 0x9cb2ed35u, 0xbaf3a58eu,
      0x51f9b18eu, 0x03ae556bu, 0xf8342e9eu, 0x81e6bec7u, 0x024cc679u},
     0x0b03b13bu},
};

__host__ __device__ constexpr uint32_t p_word(int f, int k) { return MODS[f].p[k]; }
__host__ __device__ constexpr uint32_t p2_word(int f, int k) { return MODS[f].p2[k]; }
__host__ __device__ constexpr uint32_t inv_of(int f) { return MODS[f].inv; }

// fn(std::integral_constant<int, K>{}) for K = 0 .. N-1, in order: inside fn
// K is a constant expression, so p_word(F, K) is an immediate.
template <class Fn, int... K>
__device__ __forceinline__ void unroll_seq(std::integer_sequence<int, K...>, Fn&& fn) {
  (fn(std::integral_constant<int, K>{}), ...);
}

template <int N, class Fn>
__device__ __forceinline__ void unroll(Fn&& fn) {
  unroll_seq(std::make_integer_sequence<int, N>{}, fn);
}

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

// ---- PTX carry-chain primitives ------------------------------------------
// CC is the chain's carry flag: a ".cc" instruction sets it, a "c" one
// (madc, addc, subc) reads it. Every statement that sets or reads CC is
// asm volatile, so they keep their order; what the compiler puts between two
// of them (moves, address arithmetic) is plain PTX, which never writes CC,
// and ptxas keeps the flag's dependences when it schedules. A chain ends on
// an instruction that does not set CC, or its flag is never read.
// The *_i forms take the second factor or operand as an immediate.
namespace ptx {
__device__ __forceinline__ uint32_t mul_lo(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t mul_hi(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.hi.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
template <uint32_t B>
__device__ __forceinline__ uint32_t mul_lo_i(uint32_t a) {
  uint32_t d;
  asm("mul.lo.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "n"(B));
  return d;
}
// a*b + c, low or high half, that starts a chain (sets CC) or continues one
#define TS_MAD(fn, op)                                                              \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b, uint32_t c) {     \
    uint32_t d;                                                                     \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));        \
    return d;                                                                       \
  }                                                                                 \
  template <uint32_t B>                                                             \
  __device__ __forceinline__ uint32_t fn##_i(uint32_t a, uint32_t c) {              \
    uint32_t d;                                                                     \
    asm volatile(op " %0, %1, %2, %3;" : "=r"(d) : "r"(a), "n"(B), "r"(c));     \
    return d;                                                                       \
  }
TS_MAD(mad_lo_cc, "mad.lo.cc.u32")
TS_MAD(mad_hi_cc, "mad.hi.cc.u32")
TS_MAD(madc_lo_cc, "madc.lo.cc.u32")
TS_MAD(madc_hi_cc, "madc.hi.cc.u32")
TS_MAD(madc_hi, "madc.hi.u32")
#undef TS_MAD
// a + b and a - b along a chain
#define TS_ADD(fn, op)                                                              \
  __device__ __forceinline__ uint32_t fn(uint32_t a, uint32_t b) {                 \
    uint32_t d;                                                                     \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));                    \
    return d;                                                                       \
  }                                                                                 \
  template <uint32_t B>                                                             \
  __device__ __forceinline__ uint32_t fn##_i(uint32_t a) {                          \
    uint32_t d;                                                                     \
    asm volatile(op " %0, %1, %2;" : "=r"(d) : "r"(a), "n"(B));                 \
    return d;                                                                       \
  }
TS_ADD(add_cc, "add.cc.u32")
TS_ADD(addc_cc, "addc.cc.u32")
TS_ADD(addc, "addc.u32")
TS_ADD(sub_cc, "sub.cc.u32")
TS_ADD(subc_cc, "subc.cc.u32")
TS_ADD(subc, "subc.u32")
#undef TS_ADD
}  // namespace ptx
// ---- end of the primitives ------------------------------------------------

#ifdef TS_MONT_CIOS_C
// The earlier product, for the benchmark's old-against-new runs only
// (scripts/bench_mont_product.py builds with -DTS_MONT_CIOS_C): CIOS in C
// over 64-bit sums, which nvcc compiles to wide multiply-adds and separate
// 64-bit adds and shifts.
template <int F>
__device__ __forceinline__ EltOf<F> mul_cios_c(const EltOf<F>& a, const EltOf<F>& b) {
  constexpr int N = words_of(F);
  constexpr uint32_t INV = inv_of(F);
  uint32_t P[N];
  unroll<N>([&](auto kc) { P[decltype(kc)::value] = p_word(F, decltype(kc)::value); });
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
    uint32_t m = t[0] * INV;
    s = (uint64_t)t[0] + (uint64_t)m * P[0];
    c = s >> 32;
#pragma unroll
    for (int j = 1; j < N; j++) {
      s = (uint64_t)t[j] + (uint64_t)m * P[j] + c;
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
#endif

// The Montgomery product keeps its running sum T (below 3pW < W^(N+1),
// W = 2^32: the bound of CIOS with a, b < 2p) in two accumulators, after
// Emmart and Weems (ARITH 2016): e, aligned at word 0, takes the products
// a_j b_i of even j; o, aligned at word 1 (o[k] weighs W^(k+1)), those of
// odd j. In each, the low and high halves of one product land in adjacent
// words and the next product's start above them, so one carry chain runs
// up a whole accumulator and a low half never waits on a high half's carry.
// T = e + W o. Reduction: m = e[0] * (-1/p) mod W, then the odd words of m p
// into o and the even ones into e; e[0] becomes 0 and T/W = e/W + o. The next
// row re-aligns for free (word indices are compile-time): o becomes the new e
// with e[1] added into its word 0, whose carry enters the new o, and e's
// words 2..N become the new o. Every partial sum of either accumulator is at
// most T, so the top word takes the last carry and none leaves it: where a
// chain's top instruction does not set CC, its carry-out is 0 by that bound
// (also at 9 words, where p's top word is 0, and at 24). After the last row
// the two are merged: (e/W + o) < 2p < R.

// Reduction step: e += (even words of m p), o += (odd words of m p).
template <int F>
__device__ __forceinline__ void reduce_row(uint32_t (&e)[words_of(F) + 1], uint32_t (&o)[words_of(F)]) {
  constexpr int N = words_of(F);
  const uint32_t m = ptx::mul_lo_i<inv_of(F)>(e[0]);
  unroll<N>([&](auto jc) {  // odd j: halves at o[j - 1], o[j]
    constexpr int j = decltype(jc)::value;
    constexpr uint32_t P = p_word(F, j);
    if constexpr (j % 2 == 1) {
      if constexpr (j == 1)
        o[0] = ptx::mad_lo_cc_i<P>(m, o[0]);
      else
        o[j - 1] = ptx::madc_lo_cc_i<P>(m, o[j - 1]);
      if constexpr (j == N - 1)
        o[j] = ptx::madc_hi_i<P>(m, o[j]);  // the top word
      else
        o[j] = ptx::madc_hi_cc_i<P>(m, o[j]);
    }
  });
  if constexpr (N % 2 == 1) o[N - 1] = ptx::addc(o[N - 1], 0);
  unroll<N>([&](auto jc) {  // even j: halves at e[j], e[j + 1]
    constexpr int j = decltype(jc)::value;
    constexpr uint32_t P = p_word(F, j);
    if constexpr (j % 2 == 0) {
      if constexpr (j == 0)
        e[0] = ptx::mad_lo_cc_i<P>(m, e[0]);  // 0 mod W: only its carry is kept
      else
        e[j] = ptx::madc_lo_cc_i<P>(m, e[j]);
      if constexpr (j + 1 == N)
        e[j + 1] = ptx::madc_hi_i<P>(m, e[j + 1]);  // the top word
      else
        e[j + 1] = ptx::madc_hi_cc_i<P>(m, e[j + 1]);
    }
  });
  if constexpr (N % 2 == 0) e[N] = ptx::addc(e[N], 0);
}

// Montgomery product a*b*R^-1, fully unrolled.
template <int F>
__device__ __forceinline__ EltOf<F> mul_unrolled(const EltOf<F>& a, const EltOf<F>& b) {
#ifdef TS_MONT_CIOS_C
  return mul_cios_c<F>(a, b);
#else
  constexpr int N = words_of(F);
  uint32_t e[N + 1], o[N];
  // row 0: the products alone; the halves of one product fill two words
#pragma unroll
  for (int j = 0; j < N; j++) {
    const uint32_t lo = ptx::mul_lo(a.w[j], b.w[0]), hi = ptx::mul_hi(a.w[j], b.w[0]);
    if (j % 2 == 0) {
      e[j] = lo;
      e[j + 1] = hi;
    } else {
      o[j - 1] = lo;
      o[j] = hi;
    }
  }
  if constexpr (N % 2 == 0)
    e[N] = 0;
  else
    o[N - 1] = 0;
  reduce_row<F>(e, o);
#pragma unroll
  for (int i = 1; i < N; i++) {
    const uint32_t bi = b.w[i];
    uint32_t e2[N + 1], o2[N];
    // T/W = o + e[1] + W (e >> 2 words): the new e is o plus e[1], the new o
    // is e's words 2..N, each taking a row of products as it is formed
    e2[0] = ptx::add_cc(o[0], e[1]);  // its carry weighs W: into o2[0]
#pragma unroll
    for (int j = 1; j < N; j += 2) {
      o2[j - 1] = ptx::madc_lo_cc(a.w[j], bi, e[j + 1]);
      if (j + 2 <= N)
        o2[j] = ptx::madc_hi_cc(a.w[j], bi, e[j + 2]);
      else
        o2[j] = ptx::madc_hi(a.w[j], bi, 0);  // j = N - 1: the top word
    }
    if constexpr (N % 2 == 1) o2[N - 1] = ptx::addc(0, 0);
    e2[0] = ptx::mad_lo_cc(a.w[0], bi, e2[0]);
    e2[1] = ptx::madc_hi_cc(a.w[0], bi, o[1]);
#pragma unroll
    for (int j = 2; j < N; j += 2) {
      e2[j] = ptx::madc_lo_cc(a.w[j], bi, o[j]);
      if (j + 1 < N)
        e2[j + 1] = ptx::madc_hi_cc(a.w[j], bi, o[j + 1]);
      else
        e2[j + 1] = ptx::madc_hi(a.w[j], bi, 0);  // j = N - 1: the top word
    }
    if constexpr (N % 2 == 0) e2[N] = ptx::addc(0, 0);
    reduce_row<F>(e2, o2);
#pragma unroll
    for (int k = 0; k < N; k++) {
      e[k] = e2[k];
      o[k] = o2[k];
    }
    e[N] = e2[N];
  }
  EltOf<F> r;
  r.w[0] = ptx::add_cc(e[1], o[0]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) r.w[k] = ptx::addc_cc(e[k + 1], o[k]);
  r.w[N - 1] = ptx::addc(e[N], o[N - 1]);
  return r;
#endif
}

// The same product as one function that its callers call: above
// INLINE_MUL_WORDS a product is thousands of instructions (2,328 multiply-adds
// at 24 words), and a curve kernel that inlined its 12-14 products would take
// ptxas minutes and spill every operand anyway.
template <int F>
__device__ __noinline__ EltOf<F> mul_called(const EltOf<F>& a, const EltOf<F>& b) {
  return mul_unrolled<F>(a, b);
}

#ifndef TS_INLINE_MUL_WORDS
#define TS_INLINE_MUL_WORDS 12
#endif
constexpr int INLINE_MUL_WORDS = TS_INLINE_MUL_WORDS;

template <int F>
__device__ __forceinline__ EltOf<F> mul(const EltOf<F>& a, const EltOf<F>& b) {
  if constexpr (words_of(F) > INLINE_MUL_WORDS)
    return mul_called<F>(a, b);
  else
    return mul_unrolled<F>(a, b);
}

// REDC(a) = a * R^-1 for any a < R: N rounds of m = t0 * (-1/p) mod W and
// t = (t + m p) / W, on one accumulator of N + 1 words (t + m p < R + W p <
// W^(N+1)). The result (a + M p)/R, M < R, is at most p, and p only where
// a = 0 mod p: the same words as the product a * 1.
template <int F>
__device__ __forceinline__ EltOf<F> redc(const EltOf<F>& a) {
  constexpr int N = words_of(F);
  uint32_t t[N + 1];
#pragma unroll
  for (int k = 0; k < N; k++) t[k] = a.w[k];
  t[N] = 0;
#pragma unroll
  for (int r = 0; r < N; r++) {
    const uint32_t m = ptx::mul_lo_i<inv_of(F)>(t[0]);
    unroll<N>([&](auto jc) {  // low halves at t[j]
      constexpr int j = decltype(jc)::value;
      constexpr uint32_t P = p_word(F, j);
      if constexpr (j == 0)
        t[0] = ptx::mad_lo_cc_i<P>(m, t[0]);  // 0 mod W
      else
        t[j] = ptx::madc_lo_cc_i<P>(m, t[j]);
    });
    t[N] = ptx::addc(t[N], 0);
    unroll<N>([&](auto jc) {  // high halves at t[j + 1]
      constexpr int j = decltype(jc)::value;
      constexpr uint32_t P = p_word(F, j);
      if constexpr (j == 0)
        t[1] = ptx::mad_hi_cc_i<P>(m, t[1]);
      else if constexpr (j + 1 < N)
        t[j + 1] = ptx::madc_hi_cc_i<P>(m, t[j + 1]);
      else
        t[N] = ptx::madc_hi_i<P>(m, t[N]);  // the top word
    });
#pragma unroll
    for (int k = 0; k < N; k++) t[k] = t[k + 1];
    t[N] = 0;
  }
  EltOf<F> res;
#pragma unroll
  for (int k = 0; k < N; k++) res.w[k] = t[k];
  return res;
}

// a + b, reduced by 2p when the sum reaches 2p (a, b < 2p; sum < 4p < R).
template <int F>
__device__ __forceinline__ EltOf<F> add(const EltOf<F>& a, const EltOf<F>& b) {
  constexpr int N = words_of(F);
  EltOf<F> s, d;
  s.w[0] = ptx::add_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N - 1; k++) s.w[k] = ptx::addc_cc(a.w[k], b.w[k]);
  s.w[N - 1] = ptx::addc(a.w[N - 1], b.w[N - 1]);
  uint32_t borrow;
  unroll<N>([&](auto kc) {
    constexpr int k = decltype(kc)::value;
    constexpr uint32_t P2 = p2_word(F, k);
    if constexpr (k == 0)
      d.w[0] = ptx::sub_cc_i<P2>(s.w[0]);
    else
      d.w[k] = ptx::subc_cc_i<P2>(s.w[k]);
  });
  borrow = ptx::subc(0, 0);  // 0 or 0xffffffff: s < 2p
  return borrow ? s : d;
}

// a - b, plus 2p when it borrows (a, b < 2p).
template <int F>
__device__ __forceinline__ EltOf<F> sub(const EltOf<F>& a, const EltOf<F>& b) {
  constexpr int N = words_of(F);
  EltOf<F> d;
  d.w[0] = ptx::sub_cc(a.w[0], b.w[0]);
#pragma unroll
  for (int k = 1; k < N; k++) d.w[k] = ptx::subc_cc(a.w[k], b.w[k]);
  const uint32_t borrow = ptx::subc(0, 0);
  if (borrow) {
    unroll<N>([&](auto kc) {
      constexpr int k = decltype(kc)::value;
      constexpr uint32_t P2 = p2_word(F, k);
      if constexpr (k == 0)
        d.w[0] = ptx::add_cc_i<P2>(d.w[0]);
      else if constexpr (k + 1 < N)
        d.w[k] = ptx::addc_cc_i<P2>(d.w[k]);
      else
        d.w[k] = ptx::addc_i<P2>(d.w[k]);  // mod R
    });
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

// ---- Fp4 = Fp2[v]/(v^2 - Z2): tpusnark's Fp4Arith (BLS24 G2) ---------------
template <int F>
struct Elt4 {
  Elt2<F> c0, c1;
};

// x * Z2 over Fp2 for the small constant Z2 = Z0 + Z1 u (u^2 = -Q), in the
// order of tpusnark's Fp4Arith._mul_z2:
// (c0 + c1 u)(Z0 + Z1 u) = (Z0 c0 - Q Z1 c1) + (Z0 c1 + Z1 c0) u.
template <int F, int Q, int Z0, int Z1>
__device__ __forceinline__ Elt2<F> mul_z2(const Elt2<F>& x) {
  static_assert(Z0 >= 0 && Z1 >= 0 && (Z0 || Z1), "a small nonzero Z2 expected");
  if constexpr (Z0 && Z1) {
    return {add<F>(small_mul<F, Z0>(x.c0), neg<F>(small_mul<F, Q * Z1>(x.c1))),
            add<F>(small_mul<F, Z0>(x.c1), small_mul<F, Z1>(x.c0))};
  } else if constexpr (Z0) {
    return {small_mul<F, Z0>(x.c0), small_mul<F, Z0>(x.c1)};
  } else {
    return {neg<F>(small_mul<F, Q * Z1>(x.c1)), small_mul<F, Z1>(x.c0)};
  }
}

}  // namespace ts

// Every entry point returns cudaGetLastError() as an int (or
// cudaErrorInvalidValue for a field or curve id it does not serve), and
// launches on the stream it is given; outputs are allocated by the caller.
#define TS_EXPORT extern "C" __attribute__((visibility("default")))

static inline int ts_blocks(long n, int threads) { return (int)((n + threads - 1) / threads); }
