"""Host <-> device point encoding (counterpart of tpusnark/curves/encoding.py).

Host points are affine python-int tuples ((x, y) for G1, (Fp2, Fp2) for G2,
(Fp4, Fp4) for the BLS24 curves' G2) or None for infinity, as in the curve's
host module (``curves/ref.py`` for BN254, ``curves/bls12381.py``,
``curves/bls12377.py``, ``curves/bw6761.py``, ``curves/bw6633.py``,
``curves/bls24315.py``, ``curves/bls24317.py``). Device points are ``(X, Y,
inf)`` with ``(words, N)`` Montgomery word tensors (G2: ``(c0, c1)`` tuples;
over Fp4 ``((c00, c01), (c10, c11))``) and a bool ``(N,)`` mask; infinity
lanes hold the placeholder (0, 1). Every function takes the base field, and
the G2 decoders the host classes of the curve's tower (and over Fp2 the
nonresidue q, u^2 = -q): there is no default curve. Where G2 lies over Fp
itself (the BW6 curves) its points are plain int pairs and take the G1
functions.
"""

from __future__ import annotations

import torch

from ..fields.tfield import Field


def g1_to_device(points, fp: Field, device="cpu"):
    """list[(x, y) | None] -> (X, Y, inf) tensors on `device`."""
    xs = [0 if pt is None else pt[0] for pt in points]
    ys = [1 if pt is None else pt[1] for pt in points]
    inf = torch.tensor([pt is None for pt in points], dtype=torch.bool)
    return (fp.encode(xs, device=device), fp.encode(ys, device=device), inf.to(device))


def g2_to_device(points, fp: Field, device="cpu"):
    """list[(Fp2, Fp2) | None] -> ((X0, X1), (Y0, Y1), inf) tensors."""

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


def g1_from_device_proj(pt, fp: Field):
    """Projective (X, Y, Z) tensors (batch 1 or N) -> list[(x, y) | None]."""
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


def g2_from_device_proj(pt, fp: Field, fp2_cls, q: int):
    """Projective G2 tensors -> list[(fp2_cls, fp2_cls) | None]. The
    projective inverse is over Fp[u]/(u^2 + q):
    (a + bu)^-1 = (a - bu) / (a^2 + q b^2)."""
    p = fp.modulus
    (X0, X1), (Y0, Y1), (Z0, Z1) = pt
    x0, x1, y0, y1, z0, z1 = (fp.decode(c) for c in (X0, X1, Y0, Y1, Z0, Z1))
    out = []
    for i in range(len(x0)):
        a, b = z0[i], z1[i]
        if a == 0 and b == 0:
            out.append(None)
            continue
        d = pow((a * a + q * b * b) % p, -1, p)
        za, zb = a * d % p, (-b) * d % p
        out.append(
            (
                fp2_cls((x0[i] * za - q * x1[i] * zb) % p, (x0[i] * zb + x1[i] * za) % p),
                fp2_cls((y0[i] * za - q * y1[i] * zb) % p, (y0[i] * zb + y1[i] * za) % p),
            )
        )
    return out


def g4_to_device(points, fp: Field, device="cpu"):
    """list[(Fp4, Fp4) | None] -> (((X00, X01), (X10, X11)), (Y...), inf)
    tensors. Host Fp4 elements are tower.make_ext towers: e.c = (Fp2, Fp2),
    each with .c = (Fp, Fp) holding the int .v (tpusnark's g4_to_device)."""

    def coord(i, j, k, dflt):
        return fp.encode([dflt if pt is None else pt[i].c[j].c[k].v for pt in points], device=device)

    inf = torch.tensor([pt is None for pt in points], dtype=torch.bool)
    X = tuple(tuple(coord(0, j, k, 0) for k in range(2)) for j in range(2))
    Y = tuple(tuple(coord(1, j, k, int(j == k == 0)) for k in range(2)) for j in range(2))
    return (X, Y, inf.to(device))


def g4_from_device_proj(pt, fp: Field, fp4_cls, fp2_cls):
    """Projective Fp4 tensors -> list[(fp4_cls, fp4_cls) | None]: the
    curve's host Fp4 and Fp2 classes, the inverse of Z over the host tower
    (tpusnark's g4_from_device_proj)."""

    def decode(e):
        (a, b), (c, d) = (tuple(fp.decode(x) for x in pair) for pair in e)
        return [fp4_cls((fp2_cls((a[i], b[i])), fp2_cls((c[i], d[i])))) for i in range(len(a))]

    out = []
    for x, y, z in zip(*(decode(e) for e in pt)):
        if z.is_zero():
            out.append(None)
        else:
            zi = z.inv()
            out.append((x * zi, y * zi))
    return out
