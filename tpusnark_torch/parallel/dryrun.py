"""One sharded Groth16 proof and one sharded PLONK proof over a device list,
both verified on the host (counterpart of tpusnark's
``__graft_entry__.py:dryrun_multichip``).

    python -m tpusnark_torch.parallel.dryrun [device ...]

runs it over the devices named (every card torch sees if none is named, e.g.
``cuda:0 cuda:0 cuda:0 cuda:0`` for four shards of one card, or ``cpu`` eight
times for the plain versions).
"""

from __future__ import annotations

import functools
import random
import sys


def _demo_circuit():
    """x^41 + x + 5 == y: a mul chain giving a 64-point domain."""
    from ..curves.ref import R
    from ..frontend.builder import Builder

    b = Builder(R)
    x = b.secret("x")
    y = b.public("y")
    acc = x
    for _ in range(40):
        acc = b.mul(acc, x)
    b.assert_is_equal(b.add(acc, x, 5), y)
    return b.compile()


def _plonk_circuit():
    """48 steps alternating acc * x and acc + x, equal to the public y;
    returns (cs, assignment)."""
    from ..curves.ref import R
    from ..frontend.plonk_builder import PlonkBuilder

    b = PlonkBuilder(R)
    x = b.secret("x")
    y = b.public("y")
    acc = x
    for i in range(48):
        acc = b.mul(acc, x) if i % 2 == 0 else b.add(acc, x)
    b.assert_is_equal(acc, y)
    xv = av = 3
    for i in range(48):
        av = av * xv % R if i % 2 == 0 else (av + xv) % R
    return b.compile(), {"x": xv, "y": av}


@functools.lru_cache(maxsize=None)
def _demo_keys(device: str):
    """(cs, pk, vk) of the demo circuit, set up on `device` from a seeded
    rng; made once per device (tpusnark caches its own the same way)."""
    import numpy as np

    from ..backend.groth16 import setup

    cs = _demo_circuit()
    rng_state = np.random.default_rng(7)
    pk, vk = setup(cs, rng=lambda: int(rng_state.integers(1, 1 << 62)), device=device)
    return cs, pk, vk


@functools.lru_cache(maxsize=None)
def _plonk_keys(device: str):
    """(cs, assignment, pk, vk) of the PLONK circuit, set up on `device`
    with tau = 987654321; made once per device."""
    from ..backend import plonk

    cs, assignment = _plonk_circuit()
    pk, vk = plonk.setup(cs, tau=987654321, device=device)
    return cs, assignment, pk, vk


def dryrun_multichip(devices=None, seed: int | None = None):
    """One sharded Groth16 prove of the demo circuit (seeded setup) and one
    sharded PLONK prove (tau = 987654321) over `devices` (every card torch
    sees where None), each checked by the port's host verifier; raises if
    either proof fails. Returns the two proofs. `seed`, if given, seeds
    their randomness (random.Random(seed) for Groth16's r and s,
    random.Random(seed + 1) for PLONK's blinders); else it is secret."""
    from ..backend import plonk
    from ..backend.groth16 import verify
    from ..backend.groth16.sharded import prove_sharded
    from ..backend.plonk.sharded import prove_sharded as plonk_prove_sharded
    from ..curves.ref import R
    from .sharding import mesh_devices

    devs = mesh_devices(devices)
    cs, pk, vk = _demo_keys(str(devs[0]))
    x = 3
    y = (pow(x, 41, R) + x + 5) % R
    g_rng = p_rng = None
    if seed is not None:
        r1, r2 = random.Random(seed), random.Random(seed + 1)
        g_rng, p_rng = (lambda: r1.randrange(R)), (lambda: r2.randrange(1, R))
    proof = prove_sharded(cs, pk, {"x": x, "y": y}, devs, rng=g_rng)
    if not verify(proof, vk, [y]):
        raise RuntimeError("the sharded Groth16 proof failed to verify")

    pcs, assignment, ppk, pvk = _plonk_keys(str(devs[0]))
    pproof = plonk_prove_sharded(pcs, ppk, assignment, devs, rng=p_rng)
    if not plonk.verify(pproof, pvk, [assignment["y"]]):
        raise RuntimeError("the sharded PLONK proof failed to verify")
    return proof, pproof


if __name__ == "__main__":
    dryrun_multichip(sys.argv[1:] or None)
    print("dryrun_multichip: OK")
