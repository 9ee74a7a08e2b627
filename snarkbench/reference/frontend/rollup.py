"""gnark's zk-rollup circuit (examples/rollup/circuit.go:28-67) as the
benchmark's reference compiles it: a frozen copy of ``define_batch`` and
the gadgets it calls, from ``tpusnark_torch/examples/rollup.py``,
``hashes/mimc.py`` (the gadget), ``gadgets/merkle.py``,
``gadgets/twistededwards.py`` and ``gadgets/eddsa.py``, over the
reference's ``r1cs.Builder``.

That builder has no ``div_unchecked`` and no ``assert_is_less_or_equal``;
both are written here over its public pieces (``new_hint``,
``_assert_product``, ``to_binary``, ``sub``, ``div``), emitting what the
port's ``frontend/api_ext.py`` and ``frontend/builder.py`` emit. The
constants (MiMC's rounds, the twisted Edwards curve) come from
``reference/rollup.py``.
"""

from __future__ import annotations

from ..rollup import BASE, EDWARDS_A, EDWARDS_D, mimc_constants


def _hint(*_args):
    raise RuntimeError("the reference compile records hints and never runs them")


# ------------------------------------------------ what the builder lacks
def div_unchecked(api, a, b):
    """a / b with 0 / 0 = 0: a hint's output res and the one check res * b
    == a (gnark's DivUnchecked); a constant b divides by its inverse."""
    ca, cb = api.constant_value(a), api.constant_value(b)
    if cb is not None:
        if cb == 0:
            assert ca == 0 or ca is None, "x/0 with x != 0"
            if ca == 0:
                return 0
        else:
            return api.div(a, b)
    (res,) = api.new_hint(_hint, 1, a, b)
    api._assert_product(res, b, a)
    return res


def assert_is_less_or_equal(api, a, b, nbits: int = 64):
    """a <= b for unconstrained operands: a, b and b - a each decomposed
    into `nbits` bits."""
    assert nbits <= api.p.bit_length() - 2
    api.to_binary(a, nbits)
    api.to_binary(b, nbits)
    api.to_binary(api.sub(b, a), nbits)


# ---------------------------------------------------------------- MiMC
class MiMCGadget:
    """In-circuit MiMC, Miyaguchi-Preneel over the builder's add and mul."""

    def __init__(self, api):
        self.api = api
        self.cts = mimc_constants()
        self.h = 0
        self.data: list = []

    def write(self, *vals):
        self.data.extend(vals)

    def _pow5(self, x):
        api = self.api
        r = api.mul(x, x)
        r = api.mul(r, r)
        return api.mul(r, x)

    def _encrypt(self, m):
        api = self.api
        x = m
        for c in self.cts:
            x = self._pow5(api.add(x, self.h, c))
        return api.add(x, self.h)

    def sum(self):
        api = self.api
        for m in self.data:
            r = self._encrypt(m)
            self.h = api.add(self.h, r, m)
        self.data = []
        return self.h


# -------------------------------------------------------------- Merkle
def verify_merkle_proof(api, root, leaf, path, path_bits):
    """The root recomputed from `leaf` and its siblings, leaf up; a bit 1
    means the node is the right child."""
    cur = leaf
    for sib, bit in zip(path, path_bits):
        left = api.select(bit, sib, cur)
        right = api.select(bit, cur, sib)
        h = MiMCGadget(api)
        h.write(left, right)
        cur = h.sum()
    api.assert_is_equal(cur, root)


# ------------------------------------------------------ twisted Edwards
class EdwardsGadget:
    """Affine twisted Edwards arithmetic, one unchecked division a
    coordinate."""

    def __init__(self, api):
        self.api = api
        self.a = EDWARDS_A
        self.d = EDWARDS_D

    def assert_on_curve(self, pt):
        api = self.api
        x, y = pt
        x2 = api.mul(x, x)
        y2 = api.mul(y, y)
        lhs = api.add(api.mul(self.a, x2), y2)
        rhs = api.add(1, api.mul(self.d, api.mul(x2, y2)))
        api.assert_is_equal(lhs, rhs)

    def add(self, p1, p2):
        api = self.api
        x1, y1 = p1
        x2, y2 = p2
        t = api.mul(self.d, x1, x2, y1, y2)
        x3 = div_unchecked(api, api.add(api.mul(x1, y2), api.mul(y1, x2)), api.add(1, t))
        y3 = div_unchecked(api, api.sub(api.mul(y1, y2), api.mul(self.a, api.mul(x1, x2))), api.sub(1, t))
        return (x3, y3)

    def double(self, p1):
        return self.add(p1, p1)

    def neg(self, p1):
        return (self.api.neg(p1[0]), p1[1])

    def select(self, cond, p1, p2):
        api = self.api
        return (api.select(cond, p1[0], p2[0]), api.select(cond, p1[1], p2[1]))

    def double_base_scalar_mul(self, p1, p2, s1, s2, nbits: int = 254):
        """s1 p1 + s2 p2, both scalars decomposed into bits, from the top."""
        api = self.api
        b1 = api.to_binary(s1, nbits)
        b2 = api.to_binary(s2, nbits)
        both = self.add(p1, p2)
        acc = (0, 1)
        for i in range(nbits - 1, -1, -1):
            acc = self.double(acc)
            take1 = b1[i]
            take2 = b2[i]
            add1 = self.add(acc, p1)
            add2 = self.add(acc, p2)
            addb = self.add(acc, both)
            sel2 = self.select(take2, addb, add1)
            sel0 = self.select(take2, add2, acc)
            acc = self.select(take1, sel2, sel0)
        return acc


# --------------------------------------------------------------- EdDSA
def verify_eddsa(api, sig_r, sig_s, msg, pubkey):
    """Q = [S]B - [H(R, A, M)]A on the curve, and 8 (R - Q) the identity."""
    curve = EdwardsGadget(api)
    h = MiMCGadget(api)
    h.write(sig_r[0], sig_r[1], pubkey[0], pubkey[1], msg)
    hram = h.sum()
    neg_a = curve.neg(pubkey)
    q = curve.double_base_scalar_mul(BASE, neg_a, sig_s, hram)
    curve.assert_on_curve(q)
    q = curve.add(curve.neg(q), sig_r)
    for _ in range(3):  # cofactor 8
        q = curve.double(q)
    api.assert_is_equal(q[0], 0)
    api.assert_is_equal(q[1], 1)


# -------------------------------------------------------------- rollup
def _account_inputs(api, name: str):
    return {k: api.secret(f"{name}_{k}") for k in ("index", "nonce", "balance", "pub_x", "pub_y")}


def _leaf_hash_gadget(api, acc):
    h = MiMCGadget(api)
    h.write(acc["index"], acc["nonce"], acc["balance"], acc["pub_x"], acc["pub_y"])
    return h.sum()


def define_batch(api, batch: int, depth: int):
    """`batch` transfers chained through secret roots ``root_mid_<j>``,
    from the public ``root_before`` to the public ``root_after``; transfer
    j's inputs are prefixed ``t<j>_``."""
    roots = [api.public("root_before")]
    for j in range(batch - 1):
        roots.append(api.secret(f"root_mid_{j}"))
    roots.append(api.public("root_after"))
    for j in range(batch):
        _transfer_define(api, f"t{j}_", roots[j], roots[j + 1], depth)


def _transfer_define(api, pfx: str, root_before, root_after, depth: int):
    snd_b = _account_inputs(api, pfx + "sender_before")
    rcv_b = _account_inputs(api, pfx + "receiver_before")
    snd_a = _account_inputs(api, pfx + "sender_after")
    rcv_a = _account_inputs(api, pfx + "receiver_after")
    amount = api.secret(pfx + "amount")
    sig_rx = api.secret(pfx + "sig_rx")
    sig_ry = api.secret(pfx + "sig_ry")
    sig_s = api.secret(pfx + "sig_s")
    paths = {
        key: [api.secret(f"path_{pfx}{key}_{i}") for i in range(depth)]
        for key in ("sender_before", "receiver_before", "sender_after", "receiver_after")
    }

    for k in ("index", "pub_x", "pub_y"):
        api.assert_is_equal(snd_b[k], snd_a[k])
        api.assert_is_equal(rcv_b[k], rcv_a[k])

    snd_bits = api.to_binary(snd_b["index"], depth)
    rcv_bits = api.to_binary(rcv_b["index"], depth)
    verify_merkle_proof(api, root_before, _leaf_hash_gadget(api, snd_b), paths["sender_before"], snd_bits)
    verify_merkle_proof(api, root_before, _leaf_hash_gadget(api, rcv_b), paths["receiver_before"], rcv_bits)
    verify_merkle_proof(api, root_after, _leaf_hash_gadget(api, snd_a), paths["sender_after"], snd_bits)
    verify_merkle_proof(api, root_after, _leaf_hash_gadget(api, rcv_a), paths["receiver_after"], rcv_bits)

    h = MiMCGadget(api)
    h.write(snd_b["nonce"], amount, snd_b["pub_x"], snd_b["pub_y"], rcv_b["pub_x"], rcv_b["pub_y"])
    digest = h.sum()
    verify_eddsa(api, (sig_rx, sig_ry), sig_s, digest, (snd_b["pub_x"], snd_b["pub_y"]))

    api.assert_is_equal(api.add(snd_b["nonce"], 1), snd_a["nonce"])
    api.assert_is_equal(rcv_b["nonce"], rcv_a["nonce"])
    assert_is_less_or_equal(api, amount, snd_b["balance"], nbits=64)
    api.assert_is_equal(api.sub(snd_b["balance"], amount), snd_a["balance"])
    api.assert_is_equal(api.add(rcv_b["balance"], amount), rcv_a["balance"])
