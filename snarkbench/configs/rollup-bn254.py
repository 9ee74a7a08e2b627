"""The zk-rollup configuration's circuit and inputs: gnark's
examples/rollup (circuit.go, operator.go), ``batch`` EdDSA-signed transfers
over a MiMC Merkle tree of ``accounts`` accounts (``depth`` siblings an
inclusion proof), chained through secret intermediate roots from the public
``root_before`` to the public ``root_after``.

``define`` runs the batch form (``define_batch``) over the port's builder
and ``tpusnark_torch/examples/rollup.py`` for the program, and over the
reference's frozen copy for the check; ``inputs`` makes the batches from a
seeded rng with the reference's arithmetic alone."""

from __future__ import annotations

from snarkbench.reference.rollup import Operator, keygen

PROGRAM_GADGETS = "tpusnark_torch.examples.rollup"
REFERENCE_GADGETS = "snarkbench.reference.frontend.rollup"
BALANCE_BITS = (40, 48)  # a starting balance is drawn in [2^40, 2^48)
AMOUNT_MAX = 1 << 20  # an amount is drawn in [1, 2^20]


def define(b, g, cfg) -> None:
    g.define_batch(b, cfg["batch"], depth=cfg["depth"])


def inputs(cfg, rng):
    """Batches without end, one chain of state: each batch starts from the
    last one's ``root_after``. The accounts' keys and starting balances come
    from the rng, nonces from 0; each transfer's sender, receiver (another
    account) and amount too. A batch costs, per transfer, one signature (a
    fixed-base multiplication and a 5-element MiMC), its digest (6
    elements), two leaves (5 each) and the nodes above them (2 each)."""
    n = cfg["accounts"]
    assert n == 1 << cfg["depth"], "a complete tree of the accounts"
    keys = [keygen(rng) for _ in range(n)]
    op = Operator(keys, [rng.randrange(1 << BALANCE_BITS[0], 1 << BALANCE_BITS[1]) for _ in range(n)])
    while True:
        out = {"root_before": op.root}
        for j in range(cfg["batch"]):
            if j:
                out[f"root_mid_{j - 1}"] = op.root
            sender = rng.randrange(n)
            receiver = (sender + rng.randrange(1, n)) % n
            amount = rng.randint(1, min(AMOUNT_MAX, op.accounts[sender].balance))
            out.update(op.transfer(sender, receiver, amount, f"t{j}_"))
        out["root_after"] = op.root
        yield out
