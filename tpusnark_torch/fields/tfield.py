"""Batched prime-field arithmetic on torch tensors.

Counterpart of ``tpusnark/fields/jfield.py:Field``. An element of a field
whose FieldSpec has n 16-bit limbs is ``words = ceil(n / 2)`` little-endian
32-bit words held in ``int32`` tensors of shape ``(words, *batch)`` (uint32
bit patterns), limb axis first, in Montgomery form with R = 2^(32 * words):
8 words for BN254 and BLS12-377 fr (R = 2^256), 9 for BLS12-381 fr
(R = 2^288), 12 for BLS12-381 fp, BLS12-377 fp and BW6-761 fr (R = 2^384),
24 for BW6-761 fp (R = 2^768). Where n is even, R is tpusnark's 2^(16 n) and the
Montgomery forms agree bit for bit; for a 17-limb spec (BLS12-381 fr)
tpusnark's R is 2^272, so this module encodes and decodes with its own R and
``convert.py`` re-encodes state that crosses between the two. 4p < R holds
for every spec, so jfield.py's lazy [0, 2p) contract carries over: outputs
of mul/add/sub stay in [0, 2p); compare values mod p.

Each operation with a hand-written kernel (mul, from_mont, add, sub, neg)
dispatches on the device of its operands: a CUDA tensor goes to the kernel in
``csrc/field.cu`` (through ``kernels.py``), a CPU tensor to the plain version
in this module. torch on the CPU has no uint32 add, shift or compare, and
``>>`` on int32 sign-extends, so the plain versions widen the words to int64.
Like jfield.py they work on whole columns: limb products are 16x16-bit
products summed along antidiagonals (``_product_cols``, in float64), and carries are
resolved for all words at once (``_normalize``, through ``_carries``)
instead of word by word. They
compute the same lazy representatives as the kernels, word for word.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import kernels
from .spec import FieldSpec

M16 = 0xFFFF
M32 = 0xFFFFFFFF
_I64 = torch.int64


def canonical_device(device) -> torch.device:
    """torch.device with the index filled in for CUDA ("cuda" -> "cuda:0")."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def compute_device(device) -> torch.device:
    """The device an entry point computes on: the card, unless the caller
    names the CPU. Raises where a card is asked for and there is none."""
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f'device {str(d)!r} asked for, but torch sees no CUDA card; pass device="cpu" to run the plain versions'
        )
    return canonical_device(d)


# ------------------------------------------------------------ host encoding
def n_words(spec: FieldSpec) -> int:
    """32-bit words per element: ceil(n_limbs / 2)."""
    return -(-spec.n_limbs // 2)


@functools.lru_cache(maxsize=None)
def mont_r(spec: FieldSpec) -> tuple[int, int]:
    """(R mod p, R^-1 mod p) for the port's R = 2^(32 * words)."""
    r = (1 << (32 * n_words(spec))) % spec.modulus
    return r, pow(r, -1, spec.modulus)


def ints_to_words(spec: FieldSpec, xs, mont: bool = True) -> np.ndarray:
    """Python ints -> (words, N) int32 words (Montgomery form, R = 2^(32
    words), by default; else the canonical value)."""
    p, m = spec.modulus, n_words(spec)
    r = mont_r(spec)[0] if mont else 1
    buf = b"".join((int(x) * r % p).to_bytes(4 * m, "little") for x in xs)
    words = np.frombuffer(buf, dtype="<u4").reshape(-1, m)
    return np.array(words.T, dtype="<u4", order="C").view(np.int32)


def words_to_ints(spec: FieldSpec, words, mont: bool = True) -> list[int]:
    """(words, *batch) words (tensor or array) -> flat list of ints mod p."""
    if isinstance(words, torch.Tensor):
        words = words.detach().cpu().numpy()
    m = n_words(spec)
    arr = np.asarray(words).view(np.uint32).reshape(m, -1)
    b = np.ascontiguousarray(arr.T.astype("<u4")).tobytes()
    p, rinv = spec.modulus, (mont_r(spec)[1] if mont else 1)
    step = 4 * m
    return [int.from_bytes(b[i : i + step], "little") * rinv % p for i in range(0, len(b), step)]


def _int_words(x: int, m: int) -> torch.Tensor:
    """(m,) int64 32-bit words of a host integer."""
    return torch.tensor([(x >> (32 * k)) & M32 for k in range(m)], dtype=_I64)


# ------------------------------------------------- int64 word plumbing (plain)
def _w64(a: torch.Tensor) -> torch.Tensor:
    """(8, *b) int32 words -> int64 values in [0, 2^32)."""
    return a.to(_I64) & M32


def _pack(w: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 bit patterns."""
    return torch.where(w > 0x7FFFFFFF, w - (1 << 32), w).to(torch.int32)


def _split16(w: torch.Tensor) -> torch.Tensor:
    """(m, *b) int64 words -> (2m, *b) 16-bit limbs, little-endian."""
    return torch.stack([w & M16, w >> 16], dim=1).reshape((2 * w.shape[0],) + tuple(w.shape[1:]))


def _bcast(c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(m,) constant -> (m, 1, ...) broadcastable against like (m, *b)."""
    return c.to(like.device).view((c.shape[0],) + (1,) * (like.dim() - 1))


def _carries(gen: torch.Tensor, prop: torch.Tensor) -> torch.Tensor:
    """The carry (or borrow) into every row of a multiword sum, for all rows
    at once: row k generates one (gen) or passes on the one it receives
    (prop, disjoint from gen). Returns (m + 1, *b) int64 0/1: row m is the
    carry out of the top row.

    Each lane's m <= 62 flags are packed into the bits of one int64, where
    one binary addition runs the whole chain: with A = G | P and B = G (so
    A & B = G and A ^ B = P), the carries of A + B are (A + B) ^ A ^ B."""
    m = gen.shape[0]
    if m > 62:
        raise ValueError(f"{m} rows: a carry chain packs at most 62 into an int64")
    shape = (m,) + (1,) * (gen.dim() - 1)
    weight = torch.ones((), dtype=_I64, device=gen.device) << torch.arange(m, device=gen.device).view(shape)
    G = (gen.to(_I64) * weight).sum(dim=0)
    P = (prop.to(_I64) * weight).sum(dim=0)
    X = ((G | P) + G) ^ P
    rows = torch.arange(m + 1, device=gen.device).view((m + 1,) + shape[1:])
    return (X.unsqueeze(0) >> rows) & 1


def _normalize(cols: torch.Tensor):
    """Non-negative int64 columns of weight 2^(32k), each < 2^62 -> (exact
    32-bit words, carry out of the top word)."""
    lo, hi = cols & M32, cols >> 32
    c = torch.cat([lo[:1], lo[1:] + hi[:-1]], dim=0)  # < 2^32 + 2^30: carries are 0/1
    # word k carries out iff c_k >= 2^32, or c_k == 2^32 - 1 and a carry comes in
    cin = _carries(c > M32, c == M32)
    s = c + cin[:-1]
    return s & M32, hi[-1] + (s[-1] >> 32)


def _sub_words(x: torch.Tensor, y: torch.Tensor):
    """Multiword x - y over words < 2^32: (words mod 2^(32m), borrow bool)."""
    d = x - y
    # word k borrows out iff x_k < y_k, or x_k == y_k and a borrow comes in
    b = _carries(d < 0, d == 0)
    return (d - b[:-1]) & M32, b[-1] == 1


def _product_cols(x16: torch.Tensor, y16: torch.Tensor) -> torch.Tensor:
    """16-bit limbs (2m, *b) x (2m, *b) -> (2m, *b) int64 columns of weight
    2^(32k) of the 64m-bit product: antidiagonal sums of the outer product,
    paired into 32-bit columns. With 2m limbs an antidiagonal sums at most
    2m products < 2^32, so at 24 words (48 limbs) each is < 48 * 2^32 < 2^38
    and a paired column < 2^55, inside _normalize's 2^62.

    The sums run as 2m shifted multiply-adds in float64, exact since every
    partial sum is an integer below 2^53."""
    n = x16.shape[0]
    x16, y16 = torch.broadcast_tensors(x16, y16)
    x, y = x16.to(torch.float64), y16.to(torch.float64)
    cols = torch.zeros((2 * n,) + tuple(x.shape[1:]), dtype=torch.float64, device=x.device)
    for i, xi in enumerate(x.unbind(0)):
        cols[i : i + n].addcmul_(y, xi)
    cols = cols.to(_I64)
    return cols[0::2] + (cols[1::2] << 16)


def _toeplitz(c16: torch.Tensor) -> torch.Tensor:
    """(2n, n) float64 matrix T of a constant's n 16-bit limbs with T[k, i] =
    c[k - i]: T @ x16 is the limb columns of c * x."""
    n = c16.shape[0]
    k = torch.arange(2 * n)[:, None] - torch.arange(n)[None]
    return torch.where((k >= 0) & (k < n), c16[k.clamp(0, n - 1)], 0).to(torch.float64)


def _const_cols(x16: torch.Tensor, toeplitz: torch.Tensor) -> torch.Tensor:
    """_product_cols of x16 (2m, *b) and a constant, as one float64 matrix
    product with the constant's Toeplitz matrix (exact, as above); the rows
    of `toeplitz` may be cut to the low columns that are wanted."""
    n, batch = x16.shape[0], tuple(x16.shape[1:])
    t = toeplitz.to(x16.device)
    cols = (t @ x16.reshape(n, -1).to(torch.float64)).to(_I64).reshape((t.shape[0],) + batch)
    return cols[0::2] + (cols[1::2] << 16)


def _flat(a: torch.Tensor) -> torch.Tensor:
    return a.reshape(a.shape[0], -1).contiguous()


def _lanes(a: torch.Tensor, shape) -> torch.Tensor:
    """`a` broadcast to `shape` (words, *batch) as the (words, lanes) operand
    of a field kernel, without a copy where the kernel can read it in place:
    one element for every lane (a broadcast constant) as a stride-0 view,
    rows whose lanes are contiguous (a column slice) as a view with their
    word stride; anything else as a contiguous copy."""
    if a.shape != shape:
        a = a.expand(shape)
    words = shape[0]
    if all(s == 0 or d == 1 for s, d in zip(a.stride()[1:], shape[1:])):
        return a.as_strided((words, a[0].numel()), (a.stride(0), 0))
    rows = a.reshape(words, -1)
    return rows if rows.shape[1] <= 1 or rows.stride(1) == 1 else rows.contiguous()


def _device_kind(*ts) -> str:
    kinds = {t.device.type for t in ts}
    if len(kinds) != 1:
        raise ValueError(f"operands on several devices: {sorted(kinds)}")
    kind = kinds.pop()
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {kind}")
    return kind


MAX_WORDS = 24


class Field:
    """Word arithmetic bound to one FieldSpec of at most MAX_WORDS words.

    Array convention: limb axis first, shape (words, *batch), int32 words.
    ``self.r`` and ``self.r2`` are R and R^2 mod p for the port's R."""

    def __init__(self, spec: FieldSpec):
        m = n_words(spec)
        if m > MAX_WORDS:
            raise ValueError(f"{spec.name}: {m} words; the plain versions cover {MAX_WORDS}")
        self.spec = spec
        self.n = m
        p = spec.modulus
        self.modulus = p
        self.r, self.r_inv = mont_r(spec)
        self.r2 = self.r * self.r % p
        self._p = _int_words(p, m)
        self._2p = _int_words(2 * p, m)
        # REDC's two products by constants: by p, and by -p^-1 mod R, of
        # which only the low m words (2m limb columns) are wanted
        self._p_toeplitz = _toeplitz(_split16(self._p))
        pp = _split16(_int_words(-pow(p, -1, 1 << (32 * m)) % (1 << (32 * m)), m))
        self._pp_low = _toeplitz(pp)[: 2 * m]
        self._consts: dict = {}

    # ------------------------------------------------------------ encoding
    def to_mont_int(self, x: int) -> int:
        return int(x) % self.modulus * self.r % self.modulus

    def encode(self, xs, mont: bool = True, device="cpu") -> torch.Tensor:
        """Python ints -> (words, len(xs)) words on `device`."""
        return torch.from_numpy(ints_to_words(self.spec, xs, mont)).to(device)

    def decode(self, a: torch.Tensor, mont: bool = True) -> list[int]:
        """(words, *batch) -> flat list of ints mod p (batch row-major)."""
        return words_to_ints(self.spec, a, mont)

    def const(self, x: int, mont: bool = False, device="cpu") -> torch.Tensor:
        """A (words,) constant; with mont, stores x*R mod p. Cached per device."""
        key = (int(x), mont, str(canonical_device(device)))
        c = self._consts.get(key)
        if c is None:
            v = self.to_mont_int(x) if mont else int(x) % self.modulus
            c = _pack(_int_words(v, self.n)).to(device)
            self._consts[key] = c
        return c

    def broadcast_const(self, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        return _bcast(c, like).expand(like.shape)

    def zeros(self, shape=(), device="cpu") -> torch.Tensor:
        return torch.zeros((self.n, *shape), dtype=torch.int32, device=device)

    def one(self, device="cpu") -> torch.Tensor:
        return self.const(1, mont=True, device=device)

    # ------------------------------------------------------------ dispatch
    def _binary(self, op: str, a, b, plain):
        if _device_kind(a, b) == "cuda":
            shape = a.shape if a.shape == b.shape else torch.broadcast_shapes(a.shape, b.shape)
            return kernels.field_binary(op, self.spec, _lanes(a, shape), _lanes(b, shape)).view(shape)
        return plain(*torch.broadcast_tensors(a, b))

    def _unary(self, op: str, a, plain):
        if _device_kind(a) == "cuda":
            return kernels.field_unary(op, self.spec, _lanes(a, a.shape)).view(a.shape)
        return plain(a)

    # ------------------------------------------------------------ add / sub
    def add(self, a, b):
        """a + b with a, b < 2p; result < 2p."""
        return self._binary("add", a, b, self.add_plain)

    def sub(self, a, b):
        """a - b with a, b < 2p; result < 2p."""
        return self._binary("sub", a, b, self.sub_plain)

    def neg(self, a):
        return self._unary("neg", a, self.neg_plain)

    def double(self, a):
        return self.add(a, a)

    def _reduce_2p(self, s):
        """s < 4p -> s - 2p if s >= 2p (int64 words)."""
        d, borrow = _sub_words(s, _bcast(self._2p, s))
        return torch.where(borrow, s, d)

    def add_plain(self, a, b):
        s, _ = _normalize(_w64(a) + _w64(b))  # < 4p < R: no carry out
        return _pack(self._reduce_2p(s))

    def _sub64(self, x, y):
        d, borrow = _sub_words(x, y)
        s, _ = _normalize(d + _bcast(self._2p, d) * borrow.to(_I64))  # mod R
        return s

    def sub_plain(self, a, b):
        return _pack(self._sub64(_w64(a), _w64(b)))

    def neg_plain(self, a):
        x = _w64(a)
        return _pack(self._sub64(torch.zeros_like(x), x))

    # ------------------------------------------------------------ Montgomery
    def mul(self, a, b):
        """Montgomery product a*b*R^-1 (B1); inputs < 2p, output < 2p."""
        return self._binary("mul", a, b, self.mul_plain)

    def from_mont(self, a):
        """REDC(a) = a*R^-1 (B2); input < 2p, output <= p (p for zero)."""
        return self._unary("from_mont", a, self.from_mont_plain)

    def _redc(self, t):
        """(2m, *b) words of T < R*p -> (m, *b) words of (T + m*p)/R with
        m = -T/p mod R: full-word Montgomery, as jfield.py's _mul_impl."""
        w = self.n
        m, _ = _normalize(_const_cols(_split16(t[:w]), self._pp_low))  # mod R
        s, _ = _normalize(t + _const_cols(_split16(m), self._p_toeplitz))
        return s[w:]  # the low half is zero mod R; result < 2p

    def mul_plain(self, a, b):
        t, _ = _normalize(_product_cols(_split16(_w64(a)), _split16(_w64(b))))
        return _pack(self._redc(t))

    def from_mont_plain(self, a):
        x = _w64(a)
        return _pack(self._redc(torch.cat([x, torch.zeros_like(x)], dim=0)))

    def square(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        return self.mul(a, self.broadcast_const(self.const(self.r2, device=a.device), a))

    def mul_const(self, a, c: int):
        """Multiply by a host constant given in normal form."""
        return self.mul(a, self.broadcast_const(self.const(c, mont=True, device=a.device), a))

    # ------------------------------------------------------------ comparisons
    def canon(self, a):
        """Map the lazy range [0, 2p) to canonical [0, p)."""
        x = _w64(a)
        d, borrow = _sub_words(x, _bcast(self._p, x))
        return _pack(torch.where(borrow, x, d))

    def is_zero(self, a):
        """a == 0 mod p for a in [0, 2p]: the representation is 0 or p."""
        p = _bcast(self._p_words(a.device), a)
        return (a == 0).all(dim=0) | (a == p).all(dim=0)

    def eq(self, a, b):
        """a == b mod p for a, b < 2p (jfield.py:541)."""
        return self.is_zero(self.sub(a, b))

    def _p_words(self, device):
        key = ("p", str(canonical_device(device)))
        c = self._consts.get(key)
        if c is None:
            c = self._consts[key] = _pack(self._p).to(device)
        return c

    @staticmethod
    def select(cond, a, b):
        """cond: (*batch,) bool; a, b: (words, *batch)."""
        return torch.where(cond, a, b)

    # ------------------------------------------------------------ inversion
    def pow_static(self, a, e: int):
        """a^e for a host integer exponent, square-and-multiply MSB first."""
        acc = self.broadcast_const(self.one(a.device), a).contiguous()
        for bit in bin(e)[2:]:
            acc = self.mul(acc, acc)
            if bit == "1":
                acc = self.mul(acc, a)
        return acc

    def inv(self, a):
        """Batched inversion via Fermat: a^(p-2); inv(0) = 0."""
        return self.pow_static(a, self.modulus - 2)

    # ------------------------------------------------------------ wide sums
    def reduce_columns(self, cols: torch.Tensor, bound: int):
        """(words, *b) int64 columns of weight 2^(32k) (each < 2^62), total
        value V <= bound, to an element congruent to V in [0, 2p). Needs
        bound < 2^32 * 2p.

        tpusnark folds wide columns down with host powers of 2^16 mod p.
        Here V = lo + c*R with lo < R and c = V / R < 2^33 p / R < 2^31 (as
        4p < R); REDC(lo) = lo/R (<= p, from_mont takes any lo < R), plus c
        is V/R < 2p, and a Montgomery product with R^2 brings it back to V."""
        if bound >= (1 << 32) * 2 * self.modulus:
            raise ValueError("reduce_columns: bound too wide")
        lo, carry = _normalize(cols)  # V = lo + carry * R
        c = torch.cat([carry[None], torch.zeros_like(lo[1:])], dim=0)
        v_over_r = self.add(self.from_mont(_pack(lo)), _pack(c))
        r2 = self.const(self.r2, device=cols.device)
        return self.mul(v_over_r, self.broadcast_const(r2, v_over_r))

    def segment_sum(self, values, segment_ids, num_segments: int, max_segment: int = 1 << 16):
        """Segmented sum mod p: values (words, T) in [0, 2p), ids (T,); at most
        max_segment values per segment, so each int64 column sums at most
        2^16 words < 2^32 (< 2^48) at any word count."""
        if max_segment > 1 << 16:
            raise ValueError("segment_sum: segments longer than 2^16")
        cols = torch.zeros((self.n, num_segments), dtype=_I64, device=values.device)
        cols.index_add_(1, segment_ids.to(_I64), _w64(values))
        return self.reduce_columns(cols, max_segment * (2 * self.modulus - 1))


@functools.lru_cache(maxsize=None)
def get_field(spec: FieldSpec) -> Field:
    return Field(spec)
