#!/usr/bin/env python3
"""The design choices of the MSM's fused kernels (csrc/msm.cuh), measured on
one GPU at the shapes of a 2^17 prove.

    python3 scripts/bench_msm_kernels.py [--curves bn254,bls12-381] [--reps 5]

Per curve and group, in turns inside one run (a, b, b, a):

* the strip pass over the affine bases with the bases limb-major (the key's
  device tables as they are: word w of point i at w * N + i) and point-major
  (one image with every word of a point contiguous, what the MSM hands the
  kernel), through the same kernel, which reads the bases through their
  strides;
* the strip pass over projective records (the flush records of the pass
  above, re-sorted as the MSM does) with the records as sorted (a strip's
  rows contiguous) and by rows (a row's lanes side by side, what the MSM hands
  the kernel; its copy is timed with it);
* the window Horner kernel (eight threads a result) and the step-by-step
  loop of one-lane pointwise adds it replaces.

Both versions of each pair must agree word for word. Every line of numbers
stands after the card's name and power limit. Needs a CUDA device; imports
neither JAX nor tpusnark.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--curves", default="bw6-761,bls12-377,bls12-381,bn254")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--log2n", type=int, default=chip_smoke.LOG2_CONSTRAINTS)
    args = ap.parse_args()
    torch, card = chip_smoke.phase_card()
    import numpy as np

    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import _pad_last, _take, get_msm_for, tree_map

    chip_smoke.phase_build()
    dev = torch.device("cuda")
    np_rng = np.random.default_rng(chip_smoke.SEED)
    n0 = (1 << args.log2n) - 6  # the wires of chip_smoke's circuit

    def timed(fn):
        return chip_smoke._time_cuda(torch, fn, args.reps)

    for curve in args.curves.split(","):
        cfg = get_curve(curve)
        fr, fp = get_field(cfg.fr_spec), get_field(cfg.fp_spec)
        for group, ops in zip(("g1", "g2"), curve_ops(curve)):
            msm = get_msm_for(group, n0, curve)
            W, (C, R) = msm.n_windows, msm.strip_shape(n0)
            X, Y, scalars, inf = chip_smoke.strip_inputs(torch, np_rng, fp, fr, n0, ops.fa)
            skey, order, ssgn = (t.to(dev) for t in msm._sort_records(scalars[:, None, :], inf, C * R))
            limb = ops._components(tree_map(lambda a: a.to(dev), (X, Y)))
            image = torch.stack([c.t() for c in limb], dim=1).contiguous()  # (N0, components, words)
            point = [image[:, i, :].t() for i in range(len(limb))]  # (words, N0), strides (1, components * words)
            d = len(limb) // 2
            fused = ops._msm_kernels()

            def strip(bases):
                return fused.strip_mixed(skey, order, ssgn, bases, n0, C, R, msm.nbuckets + 1)

            a, b = strip(limb), strip(point)
            same = chip_smoke._words_differ(torch, [a[0]] + a[1], [b[0]] + b[1]) == 0
            del a, b
            t = [timed(lambda: strip(bases)) for bases in (limb, point, point, limb)]
            print(
                f"[{card}] {curve} {group} strip pass over the bases, {W * C} lanes x {R} rows: "
                f"limb-major {t[0]:.4f} {t[3]:.4f} ms, point-major {t[1]:.4f} {t[2]:.4f} ms, equal={same}",
                flush=True,
            )
            if not same:
                chip_smoke.fail(f"{curve} {group}: the strip pass differs between the two layouts of the bases")

            # the projective strip pass over the flush records of that pass
            fkeys, comps = strip(point)
            K = min(fkeys.shape[-1], msm.nbuckets + C)
            ridx = torch.argsort(fkeys, dim=-1, stable=True)[:, :K]
            C2 = max(128, min(1024, 1 << max(0, (K - 1).bit_length() - 5)))
            R2 = -(-K // C2)
            sent2 = (msm.nbuckets >> 8) + 1
            skey2 = _pad_last(torch.gather(fkeys, -1, ridx) >> 8, C2 * R2, sent2)
            recs = [_pad_last(_take(c, ridx), C2 * R2).reshape(fp.n, W, C2, R2) for c in comps]
            skey2 = skey2.reshape(W, C2, R2)
            del fkeys, comps

            def by_rows(x):
                return x.transpose(-1, -2).contiguous().transpose(-1, -2)

            def strip2(rows):
                if rows:
                    return fused.strip(by_rows(skey2), [by_rows(c) for c in recs], C2, R2, sent2)
                return fused.strip(skey2, recs, C2, R2, sent2)

            a, b = strip2(False), strip2(True)
            same = chip_smoke._words_differ(torch, [a[0]] + a[1], [b[0]] + b[1]) == 0
            del a, b
            t = [timed(lambda: strip2(rows)) for rows in (False, True, True, False)]
            print(
                f"[{card}] {curve} {group} strip pass over records, {W * C2} lanes x {R2} rows: "
                f"as sorted {t[0]:.4f} {t[3]:.4f} ms, by rows (with the copy) {t[1]:.4f} {t[2]:.4f} ms, equal={same}",
                flush=True,
            )
            if not same:
                chip_smoke.fail(f"{curve} {group}: the strip pass differs between the two layouts of the records")
            del recs, skey2

            # the window Horner over W random points, one result
            def coordinate():
                return torch.from_numpy(chip_smoke._lazy_words(np_rng, W, fp.modulus, fp.n)).reshape(fp.n, W, 1).to(dev)

            ws = ops._point([coordinate() for _ in range(3 * d)])

            def horner():
                return fused.horner(ops._components(ws), msm.c)

            def loop():
                acc = tree_map(lambda x: x[:, -1], ws)
                for w in range(W - 2, -1, -1):
                    for _ in range(msm.c):
                        acc = ops.double(acc)
                    acc = ops.add(acc, tree_map(lambda x: x[:, w], ws))
                return ops._components(acc)

            same = chip_smoke._words_differ(torch, horner(), loop()) == 0
            t = [timed(horner), timed(loop), timed(loop), timed(horner)]
            print(
                f"[{card}] {curve} {group} Horner over {W} windows, c={msm.c}, 1 result: "
                f"kernel {t[0]:.4f} {t[3]:.4f} ms, loop of {(W - 1) * (msm.c + 1)} pointwise launches "
                f"{t[1]:.4f} {t[2]:.4f} ms, equal={same}",
                flush=True,
            )
            if not same:
                chip_smoke.fail(f"{curve} {group}: the Horner versions differ")


if __name__ == "__main__":
    main()
