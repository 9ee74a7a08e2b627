"""Groth16 proof / proving-key / verifying-key serialization, gnark layout.

Mirrors gnark/backend/groth16/bn254/marshal.go:
  Proof.WriteTo  -> Ar | Bs | Krs (compressed) | [u32 nbCommitments|points]
                    | CommitmentPok
  VK.WriteTo     -> G1.Alpha | G1.Beta | G2.Beta | G2.Gamma | G1.Delta
                    | G2.Delta | [u32 len(K) | K...]
                    | publicAndCommitmentCommitted | commitment key
  PK.WriteTo (marshal.go:235-290) ->
       fft.Domain | Alpha | Beta | Delta | [A] | [B] | [Z] | [K]
       | G2.Beta | G2.Delta | [B2] | u64 nbWires | u64 NbInfinityA
       | u64 NbInfinityB | InfinityA | InfinityB | u32 nbCommitmentKeys
    where [A]/[B]/[B2] carry only the non-infinity points and the masks
    mark the dropped slots (setup.go:213-239 filtering).

Caveats (documented, not hidden): two encodings inside the PK stream are
hand-derived from the gnark-crypto v0.12 API and are round-trip-tested but
NOT validated against gnark-produced bytes: (a) fft.Domain.WriteTo is
written as u64 cardinality + 5 fr elements (cardinality^-1, generator,
generator^-1, multiplicative generator, its inverse), 32-byte big-endian
each; (b) []bool masks are u32 length + one 0/1 byte per entry. Proof and
VK streams contain neither and follow gnark exactly.

The port's copy of tpusnark/backend/groth16/marshal.py: same code, on the
port's key containers (their device tables are not serialized).
"""

from __future__ import annotations

import struct

from ...curves.marshal import (
    g1_compress,
    g1_decode,
    g1_raw,
    g2_compress,
    g2_decode,
    g2_raw,
)
from .keys import Proof, ProvingKey, VerifyingKey


def proof_to_bytes(proof: Proof, raw: bool = False) -> bytes:
    """gnark proof layout (backend/groth16/bn254/marshal.go WriteTo):
    Ar | Bs | Krs | uint32 nbCommitments | commitments... | commitmentPok."""
    eg1 = g1_raw if raw else g1_compress
    eg2 = g2_raw if raw else g2_compress
    out = eg1(proof.ar) + eg2(proof.bs) + eg1(proof.krs)
    out += struct.pack(">I", len(proof.commitments))
    for c in proof.commitments:
        out += eg1(c)
    out += eg1(proof.commitment_pok if proof.commitments else None)
    return out


def proof_from_bytes(data: bytes) -> Proof:
    off = 0
    ar, n = g1_decode(data[off:])
    off += n
    bs, n = g2_decode(data[off:])
    off += n
    krs, n = g1_decode(data[off:])
    off += n
    (nb_comm,) = struct.unpack_from(">I", data, off)
    off += 4
    commitments = []
    for _ in range(nb_comm):
        c, n = g1_decode(data[off:])
        off += n
        commitments.append(c)
    pok, n = g1_decode(data[off:])
    off += n
    return Proof(
        ar=ar,
        krs=krs,
        bs=bs,
        commitments=commitments,
        commitment_pok=pok if nb_comm else None,
    )


def vk_to_bytes(vk: VerifyingKey, raw: bool = False) -> bytes:
    eg1 = g1_raw if raw else g1_compress
    eg2 = g2_raw if raw else g2_compress
    # gnark serializes vk.G1.Beta / vk.G1.Delta (= pk's values, carried for
    # compatibility, setup.go:326-327) between the G2 sections
    out = eg1(vk.alpha_g1) + eg1(vk.beta_g1) + eg2(vk.beta_g2)
    out += eg2(vk.gamma_g2) + eg1(vk.delta_g1) + eg2(vk.delta_g2)
    out += struct.pack(">I", len(vk.k))
    for pt in vk.k:
        out += eg1(pt)
    # publicAndCommitmentCommitted as [][]uint64 (gnark-crypto encoder layout:
    # u32 outer len, then per row u32 len + u64 entries; marshal.go:154-159)
    out += struct.pack(">I", len(vk.public_and_commitment_committed))
    for row in vk.public_and_commitment_committed:
        out += struct.pack(">I", len(row))
        for v in row:
            out += struct.pack(">Q", int(v))
    # pedersen VerifyingKey ALWAYS follows (marshal.go:100-104): two G2
    # points (G, GRootSigmaNeg), infinity-encoded when no commitments exist
    ck = vk.commitment_key
    out += eg2(ck.g2 if ck else None) + eg2(ck.g2_sigma_neg if ck else None)
    return out


def vk_from_bytes(data: bytes) -> VerifyingKey:
    off = 0
    alpha, n = g1_decode(data[off:])
    off += n
    beta_g1, n = g1_decode(data[off:])
    off += n
    beta_g2, n = g2_decode(data[off:])
    off += n
    gamma_g2, n = g2_decode(data[off:])
    off += n
    delta_g1, n = g1_decode(data[off:])
    off += n
    delta_g2, n = g2_decode(data[off:])
    off += n
    (nk,) = struct.unpack_from(">I", data, off)
    off += 4
    k = []
    for _ in range(nk):
        pt, n = g1_decode(data[off:])
        off += n
        k.append(pt)
    (nrows,) = struct.unpack_from(">I", data, off)
    off += 4
    pacc = []
    for _ in range(nrows):
        (m,) = struct.unpack_from(">I", data, off)
        off += 4
        row = [struct.unpack_from(">Q", data, off + 8 * i)[0] for i in range(m)]
        off += 8 * m
        pacc.append(row)
    ck_g2, n = g2_decode(data[off:])
    off += n
    ck_g2_sigma_neg, n = g2_decode(data[off:])
    off += n
    commitment_key = None
    if ck_g2 is not None or ck_g2_sigma_neg is not None:
        from ...curves.pedersen import PedersenVerifyingKey

        commitment_key = PedersenVerifyingKey(g2=ck_g2, g2_sigma_neg=ck_g2_sigma_neg)
    return VerifyingKey(
        alpha_g1=alpha,
        beta_g2=beta_g2,
        gamma_g2=gamma_g2,
        delta_g2=delta_g2,
        k=k,
        beta_g1=beta_g1,
        delta_g1=delta_g1,
        commitment_key=commitment_key,
        public_and_commitment_committed=pacc,
    )


# --------------------------------------------------------------- proving key
def _fr_bytes(x: int) -> bytes:
    return int(x).to_bytes(32, "big")


def _domain_to_bytes(n: int) -> bytes:
    """fft.Domain stream (hand-derived; see module docstring caveat (a))."""
    from ...fields.spec import BN254_FR
    from ...poly.domain import Domain

    d = Domain(BN254_FR, n)
    p = BN254_FR.modulus
    out = struct.pack(">Q", n)
    for v in (
        pow(n, -1, p),
        d.generator,
        pow(d.generator, -1, p),
        d.coset_shift,
        pow(d.coset_shift, -1, p),
    ):
        out += _fr_bytes(v)
    return out


_DOMAIN_BYTES = 8 + 5 * 32


def _bools_to_bytes(mask: list[bool]) -> bytes:
    return struct.pack(">I", len(mask)) + bytes(1 if b else 0 for b in mask)


def _bools_from_bytes(data: bytes, off: int):
    (n,) = struct.unpack_from(">I", data, off)
    off += 4
    return [b != 0 for b in data[off : off + n]], off + n


def pk_to_bytes(pk: ProvingKey, raw: bool = False) -> bytes:
    eg1 = g1_raw if raw else g1_compress
    eg2 = g2_raw if raw else g2_compress
    inf_a = [pt is None for pt in pk.a]
    inf_b = [pt is None for pt in pk.b1]

    def pts_g1(pts):
        body = b"".join(eg1(pt) for pt in pts if pt is not None)
        return struct.pack(">I", sum(pt is not None for pt in pts)) + body

    out = _domain_to_bytes(pk.domain_n)
    out += eg1(pk.alpha_g1) + eg1(pk.beta_g1) + eg1(pk.delta_g1)
    out += pts_g1(pk.a) + pts_g1(pk.b1)
    out += struct.pack(">I", len(pk.z)) + b"".join(eg1(pt) for pt in pk.z)
    out += struct.pack(">I", len(pk.k)) + b"".join(eg1(pt) for pt in pk.k)
    out += eg2(pk.beta_g2) + eg2(pk.delta_g2)
    nb2 = sum(1 for i, pt in enumerate(pk.b2) if not inf_b[i])
    out += struct.pack(">I", nb2) + b"".join(
        eg2(pt) for i, pt in enumerate(pk.b2) if not inf_b[i]
    )
    out += struct.pack(">Q", len(pk.a))  # nbWires
    out += struct.pack(">Q", sum(inf_a))  # NbInfinityA
    out += struct.pack(">Q", sum(inf_b))
    out += _bools_to_bytes(inf_a) + _bools_to_bytes(inf_b)
    # pedersen ProvingKeys (marshal.go:277-290): u32 count, then per key
    # Basis ([]G1: u32 len + points) and BasisExpSigma
    out += struct.pack(">I", len(pk.commitment_keys))
    for ck in pk.commitment_keys:
        out += pts_g1(ck.basis) + pts_g1(ck.basis_exp_sigma)
    return out


def pk_from_bytes(data: bytes) -> ProvingKey:
    off = 0
    (n,) = struct.unpack_from(">Q", data, off)
    off += _DOMAIN_BYTES

    def dec_g1():
        nonlocal off
        pt, used = g1_decode(data[off:])
        off += used
        return pt

    def dec_g2():
        nonlocal off
        pt, used = g2_decode(data[off:])
        off += used
        return pt

    def dec_g1_list():
        nonlocal off
        (m,) = struct.unpack_from(">I", data, off)
        off += 4
        return [dec_g1() for _ in range(m)]

    alpha, beta1, delta1 = dec_g1(), dec_g1(), dec_g1()
    a_f = dec_g1_list()
    b1_f = dec_g1_list()
    z = dec_g1_list()
    k = dec_g1_list()
    beta2, delta2 = dec_g2(), dec_g2()
    (nb2,) = struct.unpack_from(">I", data, off)
    off += 4
    b2_f = [dec_g2() for _ in range(nb2)]
    (nb_wires,) = struct.unpack_from(">Q", data, off)
    off += 8 + 8 + 8  # nbWires, NbInfinityA, NbInfinityB
    inf_a, off = _bools_from_bytes(data, off)
    inf_b, off = _bools_from_bytes(data, off)
    (nb_ck,) = struct.unpack_from(">I", data, off)
    off += 4
    commitment_keys = []
    if nb_ck:
        from ...curves.pedersen import PedersenProvingKey

        for _ in range(nb_ck):
            basis = dec_g1_list()
            basis_exp_sigma = dec_g1_list()
            commitment_keys.append(
                PedersenProvingKey(basis=basis, basis_exp_sigma=basis_exp_sigma)
            )

    def unfilter(filtered, mask):
        it = iter(filtered)
        return [None if m else next(it) for m in mask]

    return ProvingKey(
        alpha_g1=alpha,
        beta_g1=beta1,
        delta_g1=delta1,
        beta_g2=beta2,
        delta_g2=delta2,
        a=unfilter(a_f, inf_a),
        b1=unfilter(b1_f, inf_b),
        b2=unfilter(b2_f, inf_b),
        k=k,
        z=z,
        domain_n=int(n),
        commitment_keys=commitment_keys,
    )
