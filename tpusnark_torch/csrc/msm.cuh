// The MSM's loops around the group law, each as one launch: B5 and B6
// redesigned for the way Pippenger uses them on this card. Each
// msm_<curve>_<group>.cu instantiates the kernels for one curve and group, so
// that the units build in parallel.
//
// Replaces the TPU kernels
//   B5  tpusnark/curves/jcurve.py FusedCurveOps.add_mixed  (RCB15 alg. 8)
//   B6  tpusnark/curves/jcurve.py FusedCurveOps.add        (RCB15 alg. 7)
// together with the loops that tpusnark's jit and lax.scan hide around them
// (tpusnark/msm/pippenger.py: strip_flush, the log-step scans, the window
// Horner). Eager PyTorch launched them step by step: 64 mixed adds with
// their selects per strip pass, 255 one-lane adds per Horner (391 at 24
// windows). Here the loop lives in the kernel:
//
//   k_strip<G, MIXED>  one lane per (window, strip) walks its R rows with the
//                      accumulator and its key in registers and writes the
//                      flush records; MIXED reads the affine bases itself
//                      through the sort's order and negates Y by the sign.
//   k_scan_step<G>     out[i] = keep(i) ? a[i] + a[i + shift] : a[i]: one
//                      step of a fold, a suffix scan or a segmented scan.
//   k_horner<G>        acc = 2^c acc + S_w over the windows, one launch.
//
// All of them run padd / padd_mixed of curve.cuh in the order of the loops
// they replace, so every output equals the step-by-step composition of the
// pointwise kernels coordinate by coordinate (not only as a group element).
//
// Records that reach no bucket cost nothing but their flush records: each
// strip launch is told the first key that reaches no bucket (the DEAD key of
// a zero digit, an infinity base or the padding; the dropped overflow keys of
// the hi and lo passes), and a row at or past it skips its loads and its add,
// its accumulator staying the identity. Sorted keys put those rows last in a
// window, so a strip is live, dead or the one strip between, and a whole
// warp skips. A kernel's products follow the live records, not the records.
//
// Bound on the H100: operations where the records are live. A strip pass is
// up to R x lanes complete adds of 11-14 Montgomery products (over Fp4 each
// is nine: ~3,700 multiply-adds at 10 words) against two element rows read
// and three written per row-lane; the accumulator no longer travels through
// device memory. Parallelism is windows x strips lanes (32,768 at 16
// windows): 64-thread blocks put ~8 warps on an SM, so the integer pipes wait
// on their carry chains; that is the occupancy a full-width MSM (random
// scalars: every digit live) gives. A sparse MSM (a witness of bits: one live
// digit in 16 windows) keeps only the strips of its live records busy, a few
// thousand lanes each running a serial chain of R adds: it is bound by that
// chain's latency, and below it by the flush records' stores, which every
// row writes whatever its key. The Horner is one serial chain of (windows -
// 1)(c + 1) adds per result: its latency counts, so eight threads share an
// add.
//
// Layout of the bases (MIXED): the kernel reads word k of component c of
// point i at in[c][k * word_stride + i * point_stride], so it takes any
// layout. Sorted records name their bases in random order: from the
// limb-major (words, N) tables a gathered point touches one 32-byte sector
// per word, from a point-major image (all words of a point contiguous) a
// few. Measured (scripts/bench_msm_kernels.py, one H100, 2^17 records, 64
// rows): point-major is 1.05-2.1 times faster, most where the products are
// cheapest against the gather (BN254 G2 10.2 -> 5.0 ms, BLS12-377 G1 6.8 ->
// 3.2 ms, BW6-761 18.6 -> 17.3 ms). So the wrapper hands the kernel a
// point-major image, built from the tables with one copy per pass (8-25 MB
// against the 134-600 MB of gathered coordinates that eager PyTorch wrote).
#pragma once

#include "curve.cuh"

namespace ts {

struct MsmArgs {
  const uint32_t* in[6 * MAX_COMPONENTS];  // coordinate components, as in CurveArgs
  uint32_t* out[3 * MAX_COMPONENTS];
  const int64_t* key;    // strip: sorted keys (W, C*R); scan step: keys (lanes) or null
  const int64_t* order;  // strip, MIXED: the base of each sorted record (W, C*R)
  const uint8_t* sign;   // strip, MIXED: records whose base is negated (W, C*R)
  int64_t* out_key;      // strip: flush keys (W, (R+1)*C)
  int64_t n[9];          // sizes, per kernel (see each kernel)
  Const b3;              // 3b or 3b'
  Const one;             // 1 (over Fp2: (1, 0); over Fp4: ((1, 0), (0, 0)))
};

constexpr int STRIP_THREADS = 64;
constexpr int SCAN_THREADS = 128;
constexpr int HORNER_THREADS = 32;

// The strip pass. n = {W windows, C strips, R rows, ., ., ., ., sentinel
// key, dropped key}. Lane (w, s) walks records w*C*R + s*R + r, r < R.
// Before row r it writes flush record (w, r*C + s): the accumulator, keyed by
// the accumulator's key when row r starts another key and by the sentinel
// otherwise; record (w, R*C + s) is the last accumulator. A row whose key is
// at or past the dropped key reaches no bucket: it reads no point and adds
// nothing, and the accumulator becomes (stays, inside a run) the identity.
// Any other row of the accumulator's key is added to it, any other restarts
// it from the row's point. MIXED (n[3..6] = N0 bases, M0 live records, word
// stride, point stride of the bases): the row's point is base order % N0
// (records past M0 are padding: the point (0, 0)), with Y negated where sign
// is set. Else (n[3..4] = strip stride, row stride): the row's point is the
// projective record of `in`, and its key that of `key`, at w*C*R + s*n[3] +
// r*n[4]: the sorted order is (R, 1), where the lanes of a warp read 4R bytes
// apart; the wrapper hands over a copy with strides (1, C), where they read
// side by side.
template <class G, bool MIXED>
__global__ void __launch_bounds__(STRIP_THREADS) k_strip(MsmArgs a) {
  using E = typename G::E;
  const long W = a.n[0], C = a.n[1], R = a.n[2], sent = a.n[7], dead = a.n[8];
  const long lane = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= W * C) return;
  const long w = lane / C, s = lane % C;
  const long n_in = W * C * R, n_out = W * (R + 1) * C;
  const long rec = w * C * R + s * R, out = w * (R + 1) * C + s;
  const E one = G::cst(a.one);
  Proj<G> acc = {G::zero(), one, G::zero()};
  long acc_key = sent;
  for (long r = 0; r < R; r++) {
    const long at = MIXED ? rec + r : w * C * R + s * a.n[3] + r * a.n[4];
    const long kk = a.key[at];
    const bool same = kk == acc_key;
    a.out_key[out + r * C] = same ? sent : acc_key;
    st_pt<G>(a.out, n_out, out + r * C, acc);
    acc_key = kk;
    if (kk >= dead) {
      acc = {G::zero(), one, G::zero()};
      continue;
    }
    if constexpr (MIXED) {
      const long idx = a.order[rec + r];
      E X2 = G::zero(), Y2 = G::zero();
      if (idx < a.n[4]) {
        const long base = idx % a.n[3];
        X2 = G::ld_strided(a.in, 0, a.n[5], a.n[6], base);
        Y2 = G::ld_strided(a.in, 1, a.n[5], a.n[6], base);
        if (a.sign[rec + r]) Y2 = G::neg(Y2);
      }
      if (same)
        acc = padd_mixed<G>(acc, X2, Y2, a.b3);
      else
        acc = {X2, Y2, one};
    } else {
      const Proj<G> q = ld_pt<G>(a.in, n_in, at);
      if (same)
        acc = padd<G>(acc, q, a.b3);
      else
        acc = q;
    }
  }
  a.out_key[out + R * C] = acc_key;
  st_pt<G>(a.out, n_out, out + R * C, acc);
}

// One step of a log-step reduction along the last axis. n = {lanes, m (the
// last axis), shift, width}. Lane i at column c = i % m keeps a[i] unless
// 0 <= c + shift < width and (with keys) key[i + shift] == key[i]; then it
// is a[i] + a[i + shift]. Lanes that keep copy and skip the products.
template <class G>
__global__ void __launch_bounds__(SCAN_THREADS) k_scan_step(MsmArgs a) {
  const long n = a.n[0], m = a.n[1], shift = a.n[2], width = a.n[3];
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long j = i % m + shift;
  bool add = j >= 0 && j < width;
  if (add && a.key != nullptr) add = a.key[i + shift] == a.key[i];
  Proj<G> p = ld_pt<G>(a.in, n, i);
  if (add) p = padd<G>(p, ld_pt<G>(a.in, n, i + shift), a.b3);
  st_pt<G>(a.out, n, i, p);
}

// One complete add shared by the eight threads t of a group: p (3 elements
// of shared memory) becomes p + q. The six independent products of each of
// algorithm 7's two product rounds go to threads 0-5, the two products by
// 3b between them to threads 0-1; sums and differences are recomputed by
// whoever needs them. sh: 14 elements (p, 3 spare, 6 products, 2 by 3b);
// q may be p itself (a doubling). Every thread of the warp calls it.
template <class G>
__device__ __forceinline__ void padd_shared(typename G::E* sh, const typename G::E* q, int t,
                                            const Const& b3) {
  using E = typename G::E;
  E* p = sh;
  E* m = sh + 6;   // t0 t1 t2 m3 m4 m5, then r0..r5
  E* b = sh + 12;  // t2b, y3b
  if (t < 6) {
    E x, y;
    if (t < 3) {
      x = p[t];
      y = q[t];
    } else {  // (X+Y)(X+Y), (Y+Z)(Y+Z), (X+Z)(X+Z)
      const int i = t == 4 ? 1 : 0, l = t == 3 ? 1 : 2;
      x = G::add(p[i], p[l]);
      y = G::add(q[i], q[l]);
    }
    m[t] = G::mul(x, y);
  }
  __syncwarp();
  if (t < 2) {
    E x = m[2];
    if (t == 1) x = G::sub(m[5], G::add(m[0], x));
    b[t] = G::mul_b3(x, b3);
  }
  __syncwarp();
  E r;
  if (t < 6) {
    const E t0 = m[0], t1 = m[1];
    const E t3 = G::sub(m[3], G::add(t0, t1));
    const E t4 = G::sub(m[4], G::add(t1, m[2]));
    const E t0n = G::add(G::add(t0, t0), t0);
    const E z3 = G::add(t1, b[0]);
    const E t1n = G::sub(t1, b[0]);
    const E y3b = b[1];
    E x, y;
    switch (t) {
      case 0: x = t4; y = y3b; break;
      case 1: x = t3; y = t1n; break;
      case 2: x = y3b; y = t0n; break;
      case 3: x = t1n; y = z3; break;
      case 4: x = t0n; y = t3; break;
      default: x = z3; y = t4; break;
    }
    r = G::mul(x, y);
  }
  __syncwarp();
  if (t < 6) m[t] = r;
  __syncwarp();
  if (t == 0) p[0] = G::sub(m[1], m[0]);
  if (t == 1) p[1] = G::add(m[3], m[2]);
  if (t == 2) p[2] = G::add(m[5], m[4]);
  __syncwarp();
}

// The window Horner. n = {k results, W windows, c}. in: the window sums
// (words, W, k); out: (words, k). acc = S[W-1]; for w = W-2 .. 0: c
// doublings, then acc += S[w]. Eight threads a result (padd_shared): with one
// thread a result the same chain took 3.0-4.4 times as long (measured, then
// removed).
template <class G>
__global__ void __launch_bounds__(HORNER_THREADS) k_horner(MsmArgs a) {
  using E = typename G::E;
  const long k = a.n[0], W = a.n[1], c = a.n[2];
  const long n = W * k;
  __shared__ E sh_all[HORNER_THREADS / 8][14];
  const int t = threadIdx.x & 7;
  E* sh = sh_all[threadIdx.x >> 3];
  const long res = (long)blockIdx.x * (HORNER_THREADS / 8) + (threadIdx.x >> 3);
  const long j = res < k ? res : k - 1;  // groups past the end shadow the last result
  if (t < 3) sh[t] = G::ld(a.in, t, n, (W - 1) * k + j);
  __syncwarp();
  for (long w = W - 2; w >= 0; w--) {
    for (long step = 0; step <= c; step++) {
      const bool dbl = step < c;
      if (!dbl && t < 3) sh[3 + t] = G::ld(a.in, t, n, w * k + j);
      __syncwarp();
      padd_shared<G>(sh, dbl ? sh : sh + 3, t, a.b3);
    }
  }
  if (res < k && t < 3) G::st(a.out, t, k, res, sh[t]);
}

// kernel: 0 = strip pass over affine bases (B5), 1 = strip pass over
// projective records, 2 = scan step, 3 = window Horner (B6). args: an MsmArgs
// on the host. G runs the kernels whose time is their products' (the strip
// passes) or a chain's latency (the Horner); GS, the same group with its
// products called, runs the scan step, a launch over a few thousand lanes:
// one more inlined group law at 12 words would add a third to a unit's
// compile time for nothing.
template <class G, class GS>
int launch_msm(int kernel, const void* args, void* stream) {
  const MsmArgs a = *(const MsmArgs*)args;
  cudaStream_t st = (cudaStream_t)stream;
  const long lanes = kernel <= 1 ? a.n[0] * a.n[1] : a.n[0];
  if (lanes <= 0) return 0;
  switch (kernel) {
    case 0:
      k_strip<G, true><<<ts_blocks(lanes, STRIP_THREADS), STRIP_THREADS, 0, st>>>(a);
      break;
    case 1:
      k_strip<G, false><<<ts_blocks(lanes, STRIP_THREADS), STRIP_THREADS, 0, st>>>(a);
      break;
    case 2:
      k_scan_step<GS><<<ts_blocks(lanes, SCAN_THREADS), SCAN_THREADS, 0, st>>>(a);
      break;
    case 3:
      k_horner<G><<<ts_blocks(lanes, HORNER_THREADS / 8), HORNER_THREADS, 0, st>>>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The groups of a curve as the fused kernels run them: G1 with its products
// inlined up to 12 words, G2 over Fp2 as curve.cuh's G2M (the Fp2 product a
// call at 12 words); and both with every product a call (GS above). G2 over
// Fp4 calls its products in every kernel (curve.cuh's mul4_called).
template <class C>
using G1M = G1F<C>;
template <class C>
using G1S = G1F<C, true>;
template <class C>
using G2S = G2F<C, true>;
template <class C>
using G4M = G4F<C>;
template <class C>
using G4S = G4F<C>;

}  // namespace ts

#define TS_MSM_ENTRY(name, C, G, GS)                                     \
  TS_EXPORT int name(int kernel, const void* args, void* stream) {      \
    return ts::launch_msm<ts::G<ts::C>, ts::GS<ts::C>>(kernel, args, stream); \
  }
