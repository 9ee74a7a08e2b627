"""The SHA-256 preimage configuration's circuit and inputs (gnark
std/hash/sha2): `message_bytes` secret bytes ``m<i>``, each range-checked to
8 bits, hashed by the SHA-256 gadget, the digest bound to the public bytes
``d0`` .. ``d31``. ``define`` runs over the port's builder and gadget for the
program and over the reference's frozen copies for the check; ``inputs``
makes the messages from a seeded rng with the reference's SHA-256."""

from __future__ import annotations

from snarkbench.reference.sha256 import sha256

PROGRAM_GADGETS = "tpusnark_torch.gadgets.sha2"
REFERENCE_GADGETS = "snarkbench.reference.frontend.sha2"


def define(b, g, cfg) -> None:
    ins = [b.secret(f"m{i}") for i in range(cfg["message_bytes"])]
    for v in ins:
        b.to_binary(v, 8)
    for i, d in enumerate(g.sha256_of_bytes(b, ins)):
        b.assert_is_equal(d, b.public(f"d{i}"))


def inputs(cfg, rng):
    """Messages without end, each drawn anew (two alike with odds of
    2^-256): every input and public value by name."""
    while True:
        msg = rng.randbytes(cfg["message_bytes"])
        out = {f"m{i}": c for i, c in enumerate(msg)}
        out.update({f"d{i}": c for i, c in enumerate(sha256(msg))})
        yield out
