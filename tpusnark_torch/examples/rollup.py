"""Toy zk-rollup: an operator proves it processed a batch of transfers.

Mirrors gnark/examples/rollup/circuit.go:28-67 + operator.go: accounts in a
MiMC Merkle tree; per transfer the circuit checks the sender/receiver
inclusion proofs against the pre-state root, the sender's EdDSA signature
over the transfer, balance/nonce updates, and the inclusion proofs of the
updated leaves against the post-state root.

The counterpart of examples/rollup.py: the same circuit and host operator,
proved with the port's Groth16 over BN254 on the card unless the caller
names the CPU. Batch 31 over 32 accounts (depth 5) is 1,034,160
constraints, the largest batch in a 2^20 domain:

    python3 -m tpusnark_torch.examples.rollup --batch 31 --accounts 32
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves import edwards
from ..fields.spec import BN254_FR
from ..gadgets.eddsa import verify_eddsa
from ..gadgets.merkle import merkle_path, merkle_root, verify_merkle_proof
from ..hashes.mimc import MiMCGadget, mimc_hash

P = BN254_FR.modulus

N_ACCOUNTS = 16
DEPTH = 4  # log2(N_ACCOUNTS)
BATCH_SIZE = 1


# --------------------------------------------------------------------- state
@dataclass
class Account:
    index: int
    nonce: int
    balance: int
    pub: tuple  # twisted Edwards point

    def leaf_hash(self) -> int:
        return mimc_hash([self.index, self.nonce, self.balance, self.pub[0], self.pub[1]])


def transfer_digest(nonce, amount, sender_pub, receiver_pub) -> int:
    return mimc_hash(
        [nonce, amount, sender_pub[0], sender_pub[1], receiver_pub[0], receiver_pub[1]]
    )


class Operator:
    """Host-side rollup state machine (reference operator.go)."""

    def __init__(self, keypairs):
        self.keypairs = keypairs
        self.accounts = [
            Account(index=i, nonce=0, balance=1_000_000, pub=kp.pk)
            for i, kp in enumerate(keypairs)
        ]

    def leaves(self):
        return [a.leaf_hash() for a in self.accounts]

    def root(self) -> int:
        return merkle_root(self.leaves(), P)

    def make_transfer(self, sender: int, receiver: int, amount: int):
        """Sign + apply one transfer; returns the witness data the circuit
        needs (pre/post accounts, merkle paths, signature, roots)."""
        snd, rcv = self.accounts[sender], self.accounts[receiver]
        digest = transfer_digest(snd.nonce, amount, snd.pub, rcv.pub)
        sig_r, sig_s = edwards.eddsa_sign(self.keypairs[sender], digest)

        leaves_before = self.leaves()
        root_before = merkle_root(leaves_before, P)
        snd_path_before = merkle_path(leaves_before, sender, P)
        rcv_path_before = merkle_path(leaves_before, receiver, P)
        pre = {
            "sender": dataclasses_copy(snd),
            "receiver": dataclasses_copy(rcv),
        }

        # state transition
        assert amount <= snd.balance
        snd.balance -= amount
        snd.nonce += 1
        rcv.balance += amount

        leaves_after = self.leaves()
        root_after = merkle_root(leaves_after, P)
        snd_path_after = merkle_path(leaves_after, sender, P)
        rcv_path_after = merkle_path(leaves_after, receiver, P)

        return {
            "pre": pre,
            "post": {
                "sender": dataclasses_copy(self.accounts[sender]),
                "receiver": dataclasses_copy(self.accounts[receiver]),
            },
            "amount": amount,
            "sig_r": sig_r,
            "sig_s": sig_s,
            "root_before": root_before,
            "root_after": root_after,
            "paths": {
                "sender_before": snd_path_before,
                "receiver_before": rcv_path_before,
                "sender_after": snd_path_after,
                "receiver_after": rcv_path_after,
            },
        }


def dataclasses_copy(a: Account) -> Account:
    return Account(a.index, a.nonce, a.balance, a.pub)


# -------------------------------------------------------------------- circuit
def _account_inputs(api, name: str):
    return {
        "index": api.secret(f"{name}_index"),
        "nonce": api.secret(f"{name}_nonce"),
        "balance": api.secret(f"{name}_balance"),
        "pub_x": api.secret(f"{name}_pub_x"),
        "pub_y": api.secret(f"{name}_pub_y"),
    }


def _leaf_hash_gadget(api, acc):
    h = MiMCGadget(api)
    h.write(acc["index"], acc["nonce"], acc["balance"], acc["pub_x"], acc["pub_y"])
    return h.sum()


def define(api):
    """Builds the batch-1 rollup circuit. Input names are flat secrets plus
    public root_before / root_after."""
    root_before = api.public("root_before")
    root_after = api.public("root_after")
    _transfer_define(api, "", root_before, root_after)


def define_batch(api, batch: int, depth: int = DEPTH):
    """Batched rollup (reference circuit.go:28-67 has BatchSizeCircuit
    transfers per proof): one pair of PUBLIC roots for the whole batch,
    intermediate state roots as chained secrets — transfer j proves
    root_{j} -> root_{j+1}."""
    roots = [api.public("root_before")]
    for j in range(batch - 1):
        roots.append(api.secret(f"root_mid_{j}"))
    roots.append(api.public("root_after"))
    for j in range(batch):
        _transfer_define(api, f"t{j}_", roots[j], roots[j + 1], depth=depth)


def _transfer_define(api, pfx: str, root_before, root_after, depth: int = DEPTH):
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
    DEPTH_LOCAL = depth

    # same keys and indices before/after
    for k in ("index", "pub_x", "pub_y"):
        api.assert_is_equal(snd_b[k], snd_a[k])
        api.assert_is_equal(rcv_b[k], rcv_a[k])

    # inclusion proofs (index bits select sibling order)
    snd_bits = api.to_binary(snd_b["index"], DEPTH_LOCAL)
    rcv_bits = api.to_binary(rcv_b["index"], DEPTH_LOCAL)
    verify_merkle_proof(api, root_before, _leaf_hash_gadget(api, snd_b),
                        paths["sender_before"], snd_bits)
    verify_merkle_proof(api, root_before, _leaf_hash_gadget(api, rcv_b),
                        paths["receiver_before"], rcv_bits)
    verify_merkle_proof(api, root_after, _leaf_hash_gadget(api, snd_a),
                        paths["sender_after"], snd_bits)
    verify_merkle_proof(api, root_after, _leaf_hash_gadget(api, rcv_a),
                        paths["receiver_after"], rcv_bits)

    # signature over h(nonce | amount | senderPub | receiverPub)
    h = MiMCGadget(api)
    h.write(snd_b["nonce"], amount, snd_b["pub_x"], snd_b["pub_y"],
            rcv_b["pub_x"], rcv_b["pub_y"])
    digest = h.sum()
    verify_eddsa(api, (sig_rx, sig_ry), sig_s, digest, (snd_b["pub_x"], snd_b["pub_y"]))

    # balance / nonce transitions (circuit.go verifyAccountUpdated)
    api.assert_is_equal(api.add(snd_b["nonce"], 1), snd_a["nonce"])
    api.assert_is_equal(rcv_b["nonce"], rcv_a["nonce"])
    api.assert_is_less_or_equal(amount, snd_b["balance"], nbits=64)
    api.assert_is_equal(api.sub(snd_b["balance"], amount), snd_a["balance"])
    api.assert_is_equal(api.add(rcv_b["balance"], amount), rcv_a["balance"])


def assignment_from_transfer(t: dict, pfx: str = "") -> dict:
    out = {
        pfx + "amount": t["amount"],
        pfx + "sig_rx": t["sig_r"][0],
        pfx + "sig_ry": t["sig_r"][1],
        pfx + "sig_s": t["sig_s"],
    }
    if not pfx:  # batch-1 circuit: roots are the two publics
        out["root_before"] = t["root_before"]
        out["root_after"] = t["root_after"]
    for role, acc in (
        ("sender_before", t["pre"]["sender"]),
        ("receiver_before", t["pre"]["receiver"]),
        ("sender_after", t["post"]["sender"]),
        ("receiver_after", t["post"]["receiver"]),
    ):
        out[f"{pfx}{role}_index"] = acc.index
        out[f"{pfx}{role}_nonce"] = acc.nonce
        out[f"{pfx}{role}_balance"] = acc.balance
        out[f"{pfx}{role}_pub_x"] = acc.pub[0]
        out[f"{pfx}{role}_pub_y"] = acc.pub[1]
    for key, (sibs, _bits) in t["paths"].items():
        for i, s in enumerate(sibs):
            out[f"path_{pfx}{key}_{i}"] = s
    return out


def batch_assignment(transfers: list[dict]) -> dict:
    """Witness for define_batch: chained roots + per-transfer prefixed data."""
    out = {
        "root_before": transfers[0]["root_before"],
        "root_after": transfers[-1]["root_after"],
    }
    for j, t in enumerate(transfers):
        out.update(assignment_from_transfer(t, pfx=f"t{j}_"))
        if j < len(transfers) - 1:
            out[f"root_mid_{j}"] = t["root_after"]
    return out


def make_test_transfer():
    kps = [edwards.eddsa_keygen(bytes([i])) for i in range(N_ACCOUNTS)]
    op = Operator(kps)
    t = op.make_transfer(sender=1, receiver=3, amount=42)
    return op, t


def make_batch(batch: int, accounts: int):
    """Operator + `batch` sequential transfers over `accounts` accounts."""
    kps = [edwards.eddsa_keygen(bytes([i % 251])) for i in range(accounts)]
    op = Operator(kps)
    transfers = []
    for j in range(batch):
        s = (2 * j + 1) % accounts
        r = (3 * j + 2) % accounts
        if r == s:
            r = (r + 1) % accounts
        transfers.append(op.make_transfer(sender=s, receiver=r, amount=10 + j))
    return op, transfers


def main(argv=None, device="cuda"):
    """Compile, set up, prove (a first and a warm prove) and verify a batch
    on `device`: the card, unless the caller passes "cpu"."""
    import argparse
    import time

    from ..backend import groth16
    from ..frontend.builder import Builder
    from ..logger import phase

    ap = argparse.ArgumentParser()
    # batch 31 x 33,360 constraints/transfer = 1,034,160, the largest batch
    # in a 2^20 domain (the BASELINE.json rollup config scale; gnark's
    # examples/rollup/circuit.go:28-67)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accounts", type=int, default=32)
    args = ap.parse_args(argv)
    depth = max(1, (args.accounts - 1).bit_length())
    assert args.accounts == 1 << depth, "--accounts must be a power of two"

    b = Builder(P)
    if args.batch == 1 and args.accounts == 16:
        define(b)
    else:
        define_batch(b, args.batch, depth=depth)
    cs = b.compile()
    print("rollup cs:", cs.stats())
    op, transfers = make_batch(args.batch, args.accounts)
    assign = (
        assignment_from_transfer(transfers[0])
        if args.batch == 1 and args.accounts == 16
        else batch_assignment(transfers)
    )
    with phase("setup", n=cs.stats()["n_constraints"]):
        pk, vk = groth16.setup(cs, device=device)
    with phase("prove"):  # builds the solver's plans and the NTT tables
        proof = groth16.prove(cs, pk, assign, device=device)
    t0 = time.perf_counter()
    proof = groth16.prove(cs, pk, assign, device=device)
    dt = time.perf_counter() - t0
    pubs = [transfers[0]["root_before"], transfers[-1]["root_after"]]
    assert groth16.verify(proof, vk, pubs)
    nc = cs.stats()["n_constraints"]
    print(
        f"rollup: groth16 proof verified  batch={args.batch} "
        f"constraints={nc} prove_s={dt:.2f} (warm)"
    )


if __name__ == "__main__":
    main()
