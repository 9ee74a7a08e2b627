"""In-circuit twisted Edwards arithmetic (BN254 companion curve).

Reference surface: gnark/std/algebra/native/twistededwards/
(Point ops, DoubleBaseScalarMul, AssertIsOnCurve). Affine formulas with one
div per coordinate; scalar multiplication is binary double-and-add over
hint-decomposed bits.

The port's copy of tpusnark/gadgets/twistededwards.py: same code, imports inside
tpusnark_torch.
"""

from __future__ import annotations

from ..curves import edwards


class EdwardsGadget:
    def __init__(self, api):
        self.api = api
        self.a = edwards.A
        self.d = edwards.D

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
        # complete TE formulas: denominators 1 +- d*x1x2y1y2 are provably
        # nonzero on the curve, so skip the inverse gate like the reference
        # (gnark/std/algebra/native/twistededwards/point.go:92-93
        # uses DivUnchecked here)
        x3 = api.div_unchecked(api.add(api.mul(x1, y2), api.mul(y1, x2)), api.add(1, t))
        y3 = api.div_unchecked(
            api.sub(api.mul(y1, y2), api.mul(self.a, api.mul(x1, x2))),
            api.sub(1, t),
        )
        return (x3, y3)

    def double(self, p1):
        return self.add(p1, p1)

    def neg(self, p1):
        return (self.api.neg(p1[0]), p1[1])

    def select(self, cond, p1, p2):
        api = self.api
        return (api.select(cond, p1[0], p2[0]), api.select(cond, p1[1], p2[1]))

    def scalar_mul(self, pt, scalar, nbits: int = 254):
        """scalar * pt; scalar is a circuit variable decomposed into bits."""
        api = self.api
        bits = api.to_binary(scalar, nbits)
        acc = (0, 1)
        cur = pt
        for b in bits:
            added = self.add(acc, cur)
            acc = self.select(b, added, acc)
            cur = self.double(cur)
        return acc

    def double_base_scalar_mul(self, p1, p2, s1, s2, nbits: int = 254):
        """s1*p1 + s2*p2 (the shape eddsa uses,
        std/algebra/native/twistededwards DoubleBaseScalarMul)."""
        api = self.api
        b1 = api.to_binary(s1, nbits)
        b2 = api.to_binary(s2, nbits)
        both = self.add(p1, p2)
        acc = (0, 1)
        for i in range(nbits - 1, -1, -1):
            acc = self.double(acc)
            # add p1 if b1, p2 if b2, both if b1&b2
            take1 = b1[i]
            take2 = b2[i]
            add1 = self.add(acc, p1)
            add2 = self.add(acc, p2)
            addb = self.add(acc, both)
            sel2 = self.select(take2, addb, add1)  # when take1
            sel0 = self.select(take2, add2, acc)  # when not take1
            acc = self.select(take1, sel2, sel0)
        return acc
