"""Twisted Edwards curve over BN254 fr (gnark-crypto's bn254/twistededwards
companion curve) + native EdDSA.

Reference: the curve parameters gnark consumes via
gnark-crypto ecc/bn254/twistededwards (used by
gnark/std/signature/eddsa/eddsa.go:35 and
std/algebra/native/twistededwards). Constants verified on-curve and of the
stated prime order in tests (tests/test_eddsa.py).

Curve: a*x^2 + y^2 = 1 + d*x^2*y^2 over fr, cofactor 8.

The port's copy of tpusnark/curves/edwards.py: same code, imports inside
tpusnark_torch.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from ..fields.spec import BN254_FR
from ..hashes.mimc import mimc_hash

P = BN254_FR.modulus
A = P - 1
D = 12181644023421730124874158521699555681764249180949974110617291017600649128846
BASE_X = 9671717474070082183213120605117400219616337014328744928644933853176787189663
BASE_Y = 16950150798460657717958625567821834550301663161624707787222815936182638968203
ORDER = 2736030358979909402780800718157159386076813972158567259200215660948447373041
COFACTOR = 8

IDENTITY = (0, 1)


def on_curve(pt) -> bool:
    x, y = pt
    return (A * x * x + y * y) % P == (1 + D * x * x % P * y * y) % P


def add(p1, p2):
    x1, y1 = p1
    x2, y2 = p2
    t = D * x1 % P * x2 % P * y1 % P * y2 % P
    x3 = (x1 * y2 + y1 * x2) % P * pow(1 + t, -1, P) % P
    y3 = (y1 * y2 - A * x1 * x2) % P * pow((1 - t) % P, -1, P) % P
    return (x3, y3)


def double(p1):
    return add(p1, p1)


def neg(p1):
    return ((-p1[0]) % P, p1[1])


def mul(pt, k: int):
    acc = IDENTITY
    k %= ORDER * COFACTOR
    while k:
        if k & 1:
            acc = add(acc, pt)
        pt = double(pt)
        k >>= 1
    return acc


def base() -> tuple:
    return (BASE_X, BASE_Y)


# ------------------------------------------------------------------- EdDSA
@dataclass
class EddsaKeypair:
    sk: int  # secret scalar
    pk: tuple  # A = sk * B
    nonce_key: bytes  # deterministic-nonce PRF key


def eddsa_keygen(seed: bytes) -> EddsaKeypair:
    h = hashlib.sha512(seed).digest()
    sk = int.from_bytes(h[:32], "little") % ORDER
    if sk == 0:
        sk = 1
    return EddsaKeypair(sk=sk, pk=mul(base(), sk), nonce_key=h[32:])


def eddsa_sign(kp: EddsaKeypair, msg: int):
    """(R, S) with R = r*B, S = r + H(Rx,Ry,Ax,Ay,msg)*sk mod ORDER.
    H is MiMC over fr — matching the in-circuit verifier
    (gnark/std/signature/eddsa/eddsa.go:58-99)."""
    msg = int(msg) % P
    r = (
        int.from_bytes(
            hashlib.sha512(kp.nonce_key + msg.to_bytes(32, "big")).digest(), "little"
        )
        % ORDER
    )
    if r == 0:
        r = 1
    R = mul(base(), r)
    hram = mimc_hash([R[0], R[1], kp.pk[0], kp.pk[1], msg])
    S = (r + hram * kp.sk) % ORDER
    return R, S


def eddsa_verify_native(pk: tuple, msg: int, R: tuple, S: int) -> bool:
    if not (on_curve(pk) and on_curve(R)):
        return False
    hram = mimc_hash([R[0], R[1], pk[0], pk[1], int(msg) % P])
    # 8*S*B == 8*R + 8*hram*A
    lhs = mul(base(), 8 * S)
    rhs = add(mul(R, 8), mul(pk, 8 * hram))
    return lhs == rhs
