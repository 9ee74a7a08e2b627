"""Plain arithmetic of gnark's zk-rollup example (examples/rollup:
``circuit.go``, ``operator.go``) for the benchmark's reference: the rollup
cell's inputs are made with this module alone, in Python ints.

Written from gnark's and gnark-crypto's descriptions:

- ``keccak256``: legacy Keccak-256 (the Keccak-f[1600] permutation, rate
  136 bytes, the pad byte 0x01 of the submission, not SHA-3's 0x06);
- ``mimc``: MiMC over BN254's r in Miyaguchi-Preneel mode, as
  std/hash/mimc: each element m is encrypted under the running h by 110
  rounds of x <- (x + h + c_i)^5, then h <- h + (E_h(m) + h) + m; the round
  constants by gnark-crypto's chain: rnd = Keccak256("seed"), then c_i =
  Keccak256^(i+1)(rnd) read big-endian mod r;
- the twisted Edwards curve of gnark-crypto's ecc/bn254/twistededwards
  ("baby jubjub"): -x^2 + y^2 = 1 + d x^2 y^2 over r, its base point, the
  prime order of its subgroup and cofactor 8; scalar multiplication in
  extended coordinates (x = X/Z, y = Y/Z, T = XY/Z), by the base point
  from a table of its multiples j 16^i B;
- EdDSA as std/signature/eddsa verifies it: R = r B, S = r + H(R, A, M) sk
  mod the subgroup's order, H the MiMC digest of (R.x, R.y, A.x, A.y, M).
  Departure: gnark-crypto draws r from the key's random half and a hash of
  the message; here r is SHA-512(nonce key || M as 32 big-endian bytes)
  read little-endian mod the order (any r gives a signature the circuit
  accepts; this one is deterministic per key and message);
- the account tree: a complete binary MiMC Merkle tree over the accounts'
  leaves MiMC(index, nonce, balance, A.x, A.y), a node MiMC(left, right),
  an inclusion proof the siblings from the leaf up;
- ``Operator``: the state machine of operator.go's updateState: a transfer
  signed by its sender over MiMC(nonce, amount, sender's key, receiver's
  key), the sender's balance less the amount and its nonce plus one, the
  receiver's balance plus the amount. Departure: the accounts and their keys
  come from a seeded rng, and each transfer's inputs are named as the
  circuit's batch form names them.
"""

from __future__ import annotations

import functools
import hashlib

from .bn254 import R

# ---------------------------------------------------------------- Keccak-256
_MASK = (1 << 64) - 1


def _round_constants() -> tuple:
    """Keccak-f[1600]'s 24 round constants from its LFSR x^8 + x^6 + x^5 +
    x^4 + 1: bit 2^j - 1 of a round's constant is the LFSR's output."""
    out, lfsr = [], 1
    for _ in range(24):
        rc = 0
        for j in range(7):
            if lfsr & 1:
                rc |= 1 << ((1 << j) - 1)
            lfsr = ((lfsr << 1) ^ 0x71) & 0xFF if lfsr & 0x80 else lfsr << 1
        out.append(rc)
    return tuple(out)


def _rotations() -> list:
    """rho's offsets r[x][y]: (t+1)(t+2)/2 mod 64 along (x, y) -> (y, 2x + 3y)."""
    rot = [[0] * 5 for _ in range(5)]
    x, y = 1, 0
    for t in range(24):
        rot[x][y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rot


_RC = _round_constants()
_ROT = _rotations()


def _rol(v: int, n: int) -> int:
    return ((v << n) | (v >> (64 - n))) & _MASK if n else v


def _keccak_f(a: list) -> None:
    """The permutation on 25 lanes, lane (x, y) at a[x + 5 y], in place."""
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rol(c[(x + 1) % 5], 1) for x in range(5)]
        for i in range(25):
            a[i] ^= d[i % 5]
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rol(a[x + 5 * y], _ROT[x][y])
        for y in range(5):
            row = b[5 * y : 5 * y + 5]
            for x in range(5):
                a[x + 5 * y] = row[x] ^ (~row[(x + 1) % 5] & _MASK & row[(x + 2) % 5])
        a[0] ^= rc


def keccak256(data: bytes) -> bytes:
    """Legacy Keccak-256 of `data` (Ethereum's, not FIPS 202's SHA3-256)."""
    rate = 136
    msg = bytearray(data)
    msg.append(0x01)
    msg.extend(b"\x00" * (-len(msg) % rate))
    msg[-1] |= 0x80
    a = [0] * 25
    for off in range(0, len(msg), rate):
        for i in range(rate // 8):
            a[i] ^= int.from_bytes(msg[off + 8 * i : off + 8 * i + 8], "little")
        _keccak_f(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))


# ---------------------------------------------------------------------- MiMC
MIMC_ROUNDS = 110


@functools.lru_cache(maxsize=None)
def mimc_constants() -> tuple:
    """The 110 round constants over r: rnd = Keccak256("seed"), then each
    constant the next Keccak256 of the chain, big-endian, mod r."""
    rnd = keccak256(b"seed")
    out = []
    for _ in range(MIMC_ROUNDS):
        rnd = keccak256(rnd)
        out.append(int.from_bytes(rnd, "big") % R)
    return tuple(out)


def mimc(elements) -> int:
    """MiMC-BN254 digest of field elements (Miyaguchi-Preneel)."""
    cts = mimc_constants()
    h = 0
    for m in elements:
        m %= R
        x = m
        for hc in [h + c for c in cts]:
            x = pow(x + hc, 5, R)
        h = (h + (x + h) + m) % R
    return h


# ------------------------------------------------------------ twisted Edwards
EDWARDS_A = R - 1
EDWARDS_D = 12181644023421730124874158521699555681764249180949974110617291017600649128846
BASE = (
    9671717474070082183213120605117400219616337014328744928644933853176787189663,
    16950150798460657717958625567821834550301663161624707787222815936182638968203,
)
ORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041
COFACTOR = 8
IDENTITY = (0, 1)
_D2 = 2 * EDWARDS_D % R


def on_curve(pt) -> bool:
    x, y = pt
    return (EDWARDS_A * x * x + y * y - 1 - EDWARDS_D * x * x % R * y * y) % R == 0


def _ext(pt):
    x, y = pt
    return (x, y, x * y % R, 1)


def _ext_add(p, q):
    """Extended coordinates, a = -1 (Hisil-Wong-Carter-Dawson, unified)."""
    x1, y1, t1, z1 = p
    x2, y2, t2, z2 = q
    a = (y1 - x1) * (y2 - x2) % R
    b = (y1 + x1) * (y2 + x2) % R
    c = t1 * _D2 % R * t2 % R
    d = 2 * z1 * z2 % R
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % R, g * h % R, e * h % R, f * g % R)


def _ext_double(p):
    x1, y1, _, z1 = p
    a = x1 * x1 % R
    b = y1 * y1 % R
    c = 2 * z1 * z1 % R
    d = -a  # a = -1
    e = ((x1 + y1) * (x1 + y1) - a - b) % R
    g = d + b
    f, h = g - c, d - b
    return (e * f % R, g * h % R, e * h % R, f * g % R)


def _affine(p):
    x, y, _, z = p
    zi = pow(z, -1, R)
    return (x * zi % R, y * zi % R)


def mul(pt, k: int):
    """k pt, double-and-add from the top bit in extended coordinates."""
    acc, base = (0, 1, 0, 1), _ext(pt)
    for bit in bin(k)[2:] if k > 0 else "":
        acc = _ext_double(acc)
        if bit == "1":
            acc = _ext_add(acc, base)
    return _affine(acc)


@functools.lru_cache(maxsize=None)
def _base_table() -> tuple:
    """j 16^i B in extended coordinates, for i < 64 and j < 16."""
    rows, step = [], _ext(BASE)
    for _ in range(64):
        row = [(0, 1, 0, 1)]
        for _ in range(15):
            row.append(_ext_add(row[-1], step))
        rows.append(tuple(row))
        step = _ext_add(row[-1], step)
    return tuple(rows)


def mul_base(k: int):
    """k B for 0 <= k < 2^256, one addition a 4-bit digit of k."""
    acc = (0, 1, 0, 1)
    for row in _base_table():
        if k & 15:
            acc = _ext_add(acc, row[k & 15])
        k >>= 4
    return _affine(acc)


def add(p, q):
    return _affine(_ext_add(_ext(p), _ext(q)))


# --------------------------------------------------------------------- EdDSA
class KeyPair:
    """An EdDSA key: the secret scalar, the public point A = sk B and the
    nonce key of the signatures."""

    __slots__ = ("sk", "pk", "nonce_key")

    def __init__(self, sk: int, nonce_key: bytes):
        self.sk, self.nonce_key = sk, nonce_key
        self.pk = mul_base(sk)


def keygen(rng) -> KeyPair:
    return KeyPair(rng.randrange(1, ORDER), rng.randbytes(32))


def sign(kp: KeyPair, msg: int):
    """(R, S) over the field element `msg`."""
    msg %= R
    r = int.from_bytes(hashlib.sha512(kp.nonce_key + msg.to_bytes(32, "big")).digest(), "little") % ORDER or 1
    big_r = mul_base(r)
    hram = mimc([big_r[0], big_r[1], kp.pk[0], kp.pk[1], msg])
    return big_r, (r + hram * kp.sk) % ORDER


def verify(pk, msg: int, big_r, s: int) -> bool:
    """8 S B == 8 R + 8 H(R, A, M) A, with A and R on the curve."""
    if not (on_curve(pk) and on_curve(big_r)) or not 0 <= s < ORDER:
        return False
    hram = mimc([big_r[0], big_r[1], pk[0], pk[1], msg % R])
    return mul(BASE, COFACTOR * s) == add(mul(big_r, COFACTOR), mul(pk, COFACTOR * hram))


# -------------------------------------------------------------------- Merkle
class MerkleTree:
    """A complete binary MiMC tree kept level by level: level 0 the
    leaves, the last level the root."""

    def __init__(self, leaves: list):
        n = len(leaves)
        assert n and n & (n - 1) == 0, "a complete tree takes a power of two of leaves"
        self.levels = [[v % R for v in leaves]]
        while len(self.levels[-1]) > 1:
            below = self.levels[-1]
            self.levels.append([mimc([below[i], below[i + 1]]) for i in range(0, len(below), 2)])

    @property
    def root(self) -> int:
        return self.levels[-1][0]

    def path(self, index: int) -> list:
        """The siblings of leaf `index`, from the leaf up."""
        out = []
        for level in self.levels[:-1]:
            out.append(level[index ^ 1])
            index //= 2
        return out

    def update(self, leaves: dict) -> None:
        """The leaves {index: value} set, and each node above them hashed
        once."""
        touched = set(leaves)
        for i, v in leaves.items():
            self.levels[0][i] = v % R
        for k in range(1, len(self.levels)):
            touched = {i // 2 for i in touched}
            below = self.levels[k - 1]
            for i in touched:
                self.levels[k][i] = mimc([below[2 * i], below[2 * i + 1]])


# ------------------------------------------------------------------ operator
class Account:
    __slots__ = ("index", "nonce", "balance", "pub")

    def __init__(self, index: int, nonce: int, balance: int, pub):
        self.index, self.nonce, self.balance, self.pub = index, nonce, balance, pub

    def leaf(self) -> int:
        return mimc([self.index, self.nonce, self.balance, self.pub[0], self.pub[1]])

    def fields(self) -> dict:
        return {"index": self.index, "nonce": self.nonce, "balance": self.balance,
                "pub_x": self.pub[0], "pub_y": self.pub[1]}


def transfer_digest(nonce: int, amount: int, sender_pub, receiver_pub) -> int:
    return mimc([nonce, amount, sender_pub[0], sender_pub[1], receiver_pub[0], receiver_pub[1]])


class Operator:
    """The rollup's state: the accounts, their keys and the tree of their
    leaves."""

    def __init__(self, keys: list, balances: list):
        self.keys = keys
        self.accounts = [Account(i, 0, bal, kp.pk) for i, (kp, bal) in enumerate(zip(keys, balances))]
        self.tree = MerkleTree([a.leaf() for a in self.accounts])

    @property
    def root(self) -> int:
        return self.tree.root

    def transfer(self, sender: int, receiver: int, amount: int, prefix: str) -> dict:
        """Sign and apply one transfer; returns its inputs, each named as
        the batch circuit names it under `prefix` (``t<j>_``), the roots
        aside."""
        snd, rcv = self.accounts[sender], self.accounts[receiver]
        if sender == receiver or not 0 < amount <= snd.balance:
            raise ValueError(f"transfer {sender} -> {receiver} of {amount} refused")
        big_r, s = sign(self.keys[sender], transfer_digest(snd.nonce, amount, snd.pub, rcv.pub))
        out = {f"{prefix}amount": amount, f"{prefix}sig_rx": big_r[0], f"{prefix}sig_ry": big_r[1],
               f"{prefix}sig_s": s}

        def record(role, acc, when):
            for k, v in acc.fields().items():
                out[f"{prefix}{role}_{when}_{k}"] = v
            for i, sib in enumerate(self.tree.path(acc.index)):
                out[f"path_{prefix}{role}_{when}_{i}"] = sib

        record("sender", snd, "before")
        record("receiver", rcv, "before")
        snd.balance -= amount
        snd.nonce += 1
        rcv.balance += amount
        self.tree.update({sender: snd.leaf(), receiver: rcv.leaf()})
        record("sender", snd, "after")
        record("receiver", rcv, "after")
        return out
