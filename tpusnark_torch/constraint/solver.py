"""Witness solver on the host (the port's copy of
tpusnark/constraint/solver.py).

gnark analog: the generated level-parallel solver
(gnark/constraint/bn254/solver.go:39-641): walk instructions,
evaluate known linear expressions, derive the single unknown wire of each
R1C, run hints, and error with the constraint id on an unsatisfied
constraint.
"""

from __future__ import annotations

from .system import ConstraintSystem


class UnsatisfiedConstraintError(Exception):
    def __init__(self, idx, dbg=None):
        super().__init__(f"constraint #{idx} is not satisfied" + (f": {dbg}" if dbg else ""))
        self.idx = idx


def solve(
    cs: ConstraintSystem,
    assignment: dict,
    hint_overrides: dict | None = None,
    logs: bool = True,
) -> list[int]:
    """assignment: name -> int for all public+secret inputs.
    Returns the full wire vector W (python ints), W[0] == 1.

    hint_overrides: {hint fn or name -> replacement fn} — the prover's
    OverrideHint seam (gnark solver.OverrideHint, used to swap the BSB22
    placeholder for the real commitment computation,
    gnark/backend/groth16/bn254/prove.go:84)."""
    p = cs.modulus
    W: list = [None] * cs.n_wires
    W[0] = 1
    for i, name in enumerate(cs.public_names[1:], start=1):
        if name not in assignment:
            raise KeyError(f"missing public input {name!r}")
        W[i] = int(assignment[name]) % p
    for j, name in enumerate(cs.secret_names):
        if name not in assignment:
            raise KeyError(f"missing secret input {name!r}")
        W[cs.n_public + j] = int(assignment[name]) % p

    coeffs = cs.coeffs

    def eval_lin(e):
        acc = 0
        for cid, vid in e:
            v = W[vid]
            if v is None:
                raise RuntimeError(f"wire {vid} used before solved")
            acc += coeffs[cid] * v
        return acc % p

    def eval_lin_partial(e, unknown):
        """(known part, coefficient of unknown)."""
        acc, k = 0, 0
        for cid, vid in e:
            if vid == unknown:
                k = (k + coeffs[cid]) % p
            else:
                v = W[vid]
                if v is None:
                    raise RuntimeError(f"wire {vid} used before solved")
                acc += coeffs[cid] * v
        return acc % p, k

    overrides = {}
    if hint_overrides:
        from .hints import hint_name

        for k, v in hint_overrides.items():
            overrides[k if isinstance(k, str) else hint_name(k)] = v

    for inst in cs.instructions:
        kind = inst[0]
        if kind == "hint":
            h = inst[1]
            ins = [eval_lin(e) for e in h.inputs]
            fn = h.fn
            if overrides:
                from .hints import hint_name

                fn = overrides.get(hint_name(fn), fn)
            outs = fn(p, ins)
            assert len(outs) == len(h.outputs), "hint output arity mismatch"
            for w, v in zip(h.outputs, outs):
                W[w] = int(v) % p
            continue
        _, cidx, solved = inst
        c = cs.constraints[cidx]
        if solved is None:
            l, r, o = eval_lin(c.L), eval_lin(c.R), eval_lin(c.O)
            if (l * r - o) % p != 0:
                raise UnsatisfiedConstraintError(cidx, cs.debug_str(cidx))
            continue
        in_l = any(v == solved for _, v in c.L)
        in_r = any(v == solved for _, v in c.R)
        in_o = any(v == solved for _, v in c.O)
        if in_o and not (in_l or in_r):
            l, r = eval_lin(c.L), eval_lin(c.R)
            o_rest, k = eval_lin_partial(c.O, solved)
            W[solved] = (l * r - o_rest) * pow(k, -1, p) % p
        elif in_l and not (in_r or in_o):
            r, o = eval_lin(c.R), eval_lin(c.O)
            l_rest, k = eval_lin_partial(c.L, solved)
            if r % p == 0:
                # (l_rest + k*w) * 0 = o -> o must be 0; w unconstrained -> 0
                if o % p != 0:
                    raise UnsatisfiedConstraintError(cidx, cs.debug_str(cidx))
                W[solved] = 0
            else:
                W[solved] = (o * pow(r, -1, p) - l_rest) * pow(k, -1, p) % p
        elif in_r and not (in_l or in_o):
            l, o = eval_lin(c.L), eval_lin(c.O)
            r_rest, k = eval_lin_partial(c.R, solved)
            if l % p == 0:
                if o % p != 0:
                    raise UnsatisfiedConstraintError(cidx, cs.debug_str(cidx))
                W[solved] = 0
            else:
                W[solved] = (o * pow(l, -1, p) - r_rest) * pow(k, -1, p) % p
        else:
            raise RuntimeError(f"constraint #{cidx}: solved wire in multiple expressions")
    Wout = [w if w is not None else 0 for w in W]
    if cs.logs and logs:
        coeffs = cs.coeffs
        cs.solve_logs = [
            " ".join(
                str(
                    v
                    if kind == "const"
                    else sum(coeffs[cid] * Wout[vid] for cid, vid in v) % p
                )
                for kind, v in entry
            )
            for entry in cs.logs
        ]
    return Wout


def compute_abc(cs: ConstraintSystem, W: list[int]):
    """Per-constraint evaluations A_i = L_i(W), B_i = R_i(W), C_i = O_i(W)."""
    p = cs.modulus
    coeffs = cs.coeffs
    A, B, C = [], [], []
    for c in cs.constraints:
        A.append(sum(coeffs[cid] * W[vid] for cid, vid in c.L) % p)
        B.append(sum(coeffs[cid] * W[vid] for cid, vid in c.R) % p)
        C.append(sum(coeffs[cid] * W[vid] for cid, vid in c.O) % p)
    return A, B, C
