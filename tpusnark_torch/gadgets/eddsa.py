"""In-circuit EdDSA verification (MiMC-hashed, twisted Edwards over fr).

Mirrors gnark/std/signature/eddsa/eddsa.go:58-99: compute
hRAM = MiMC(R.x, R.y, A.x, A.y, msg), Q = [S]B - [hRAM]A - R, multiply by
the cofactor (3 doublings), and assert Q is the identity (0, 1).

The port's copy of tpusnark/gadgets/eddsa.py: same code, imports inside
tpusnark_torch.
"""

from __future__ import annotations

from ..curves import edwards
from ..hashes.mimc import MiMCGadget
from .twistededwards import EdwardsGadget


def verify_eddsa(api, sig_r, sig_s, msg, pubkey):
    """sig_r: (x, y) circuit vars; sig_s: circuit var; pubkey: (x, y)."""
    curve = EdwardsGadget(api)
    h = MiMCGadget(api)
    h.write(sig_r[0], sig_r[1], pubkey[0], pubkey[1], msg)
    hram = h.sum()

    base = (edwards.BASE_X, edwards.BASE_Y)
    neg_a = curve.neg(pubkey)
    q = curve.double_base_scalar_mul(base, neg_a, sig_s, hram)
    curve.assert_on_curve(q)
    # Q - R, then clear the cofactor
    q = curve.add(curve.neg(q), sig_r)
    for _ in range(3):  # cofactor 8
        q = curve.double(q)
    api.assert_is_equal(q[0], 0)
    api.assert_is_equal(q[1], 1)
