"""Host <-> device point encoding (counterpart of tpusnark/curves/encoding.py).

Host points are affine python-int tuples ((x, y) for G1, (Fp2, Fp2) for G2)
or None for infinity, as in ``tpusnark.curves.ref``. Device points are
``(X, Y, inf)`` with ``(8, N)`` Montgomery word tensors (G2: ``(c0, c1)``
tuples) and a bool ``(N,)`` mask; infinity lanes hold the placeholder
(0, 1).
"""

from __future__ import annotations

import torch

from tpusnark.curves.ref import Fp2
from tpusnark.fields.spec import BN254_FP

from ..fields.tfield import Field, get_field


def g1_to_device(points, fp: Field | None = None, device="cpu"):
    """list[(x, y) | None] -> (X, Y, inf) tensors on `device`."""
    fp = fp or get_field(BN254_FP)
    xs = [0 if pt is None else pt[0] for pt in points]
    ys = [1 if pt is None else pt[1] for pt in points]
    inf = torch.tensor([pt is None for pt in points], dtype=torch.bool)
    return (fp.encode(xs, device=device), fp.encode(ys, device=device), inf.to(device))


def g2_to_device(points, fp: Field | None = None, device="cpu"):
    """list[(Fp2, Fp2) | None] -> ((X0, X1), (Y0, Y1), inf) tensors."""
    fp = fp or get_field(BN254_FP)

    def coord(i, c, dflt):
        return fp.encode(
            [dflt if pt is None else getattr(pt[i], c) for pt in points], device=device
        )

    inf = torch.tensor([pt is None for pt in points], dtype=torch.bool)
    return (
        (coord(0, "c0", 0), coord(0, "c1", 0)),
        (coord(1, "c0", 1), coord(1, "c1", 0)),
        inf.to(device),
    )


def g1_from_device_proj(pt, fp: Field | None = None):
    """Projective (X, Y, Z) tensors (batch 1 or N) -> list[(x, y) | None]."""
    fp = fp or get_field(BN254_FP)
    p = fp.modulus
    xs, ys, zs = (fp.decode(c) for c in pt)
    out = []
    for x, y, z in zip(xs, ys, zs):
        if z == 0:
            out.append(None)
        else:
            zi = pow(z, -1, p)
            out.append((x * zi % p, y * zi % p))
    return out


def g2_from_device_proj(pt, fp: Field | None = None):
    """Projective G2 tensors -> list[(Fp2, Fp2) | None] (u^2 = -1)."""
    fp = fp or get_field(BN254_FP)
    p = fp.modulus
    (X0, X1), (Y0, Y1), (Z0, Z1) = pt
    x0, x1, y0, y1, z0, z1 = (fp.decode(c) for c in (X0, X1, Y0, Y1, Z0, Z1))
    out = []
    for i in range(len(x0)):
        a, b = z0[i], z1[i]
        if a == 0 and b == 0:
            out.append(None)
            continue
        d = pow((a * a + b * b) % p, -1, p)
        za, zb = a * d % p, (-b) * d % p
        out.append(
            (
                Fp2((x0[i] * za - x1[i] * zb) % p, (x0[i] * zb + x1[i] * za) % p),
                Fp2((y0[i] * za - y1[i] * zb) % p, (y0[i] * zb + y1[i] * za) % p),
            )
        )
    return out
