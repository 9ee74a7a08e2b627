"""GKR protocol for layered arithmetic circuits.

The analog of gnark's GKR stack: constraint-level metadata + hints
(gnark/constraint/gkr.go:18-42, std/gkr/api.go:12,
std/gkr/compile.go:16-45) backed by gnark-crypto's sumcheck-based GKR prover.
Redesigned rather than translated: one layer relation

    W_i(z) = sum_{x,y} [ add_i(z,x,y) (W_{i+1}(x) + W_{i+1}(y))
                       + mul_i(z,x,y)  W_{i+1}(x)  W_{i+1}(y) ]

proved per layer with the sums-of-products sumcheck (protocols/sumcheck.py),
two-claim-to-one reduction by random linear combination (alpha, beta) of the
wiring predicates. Fiat-Shamir over MiMC so the host prover's transcript is
replayable by the in-circuit verifier gadget.

Layer 0 is the OUTPUT layer; the last layer reads the circuit inputs.

The port's copy of tpusnark/protocols/gkr.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass

from .multilinear import MultiLin, eq_table
from .sumcheck import Transcript, prove_terms, verify_rounds, verify_rounds_in_circuit

ADD, MUL = 0, 1


@dataclass
class Gate:
    op: int  # ADD | MUL
    a: int   # index into next (deeper) layer
    b: int


@dataclass
class LayeredCircuit:
    """layers[0] = output gates; each gate reads layer i+1 (or the inputs for
    the last layer). n_inputs and every layer size must be a power of two."""

    layers: list[list[Gate]]
    n_inputs: int

    def __post_init__(self):
        assert self.n_inputs & (self.n_inputs - 1) == 0
        for layer in self.layers:
            n = len(layer)
            assert n & (n - 1) == 0

    def evaluate(self, inputs: list[int], p: int) -> list[list[int]]:
        """All layer values, deepest first return order NOT — returns
        [outputs, ..., last_hidden] plus inputs implicitly."""
        vals = [v % p for v in inputs]
        acc = []
        for layer in reversed(self.layers):
            nxt = []
            for g in layer:
                x, y = vals[g.a], vals[g.b]
                nxt.append((x + y) % p if g.op == ADD else x * y % p)
            acc.append(nxt)
            vals = nxt
        return acc[::-1]  # [output layer, ..., deepest hidden layer]


@dataclass
class LayerProof:
    rounds: list[list[int]]  # sumcheck rounds, deg-3 univariates
    wu: int                  # claimed W_{i+1}(u')
    wv: int                  # claimed W_{i+1}(v')


@dataclass
class GkrProof:
    layers: list[LayerProof]


# ------------------------------------------------------------------ helpers
def _kvars(n: int) -> int:
    return (n - 1).bit_length() if n > 1 else 1


def _pad(vals: list[int], k: int) -> list[int]:
    return vals + [0] * ((1 << k) - len(vals))


def _eq_point_gate(point: list[int], g: int, p: int) -> int:
    """eq(point, bits(g)) — host."""
    acc = 1
    for j, w in enumerate(point):
        bit = (g >> j) & 1
        acc = acc * ((w if bit else (1 - w)) % p) % p
    return acc


def _wiring_tables(layer, ku, alpha, beta, equ, eqv, p):
    """A, M multilinears over the joint (x, y) domain (2^(2*ku) entries):
    A[x + 2^ku * y] = Σ_{add gates g with ins (x,y)} alpha*equ[g] + beta*eqv[g]
    (and M for mul gates)."""
    size = 1 << (2 * ku)
    A = [0] * size
    M = [0] * size
    for g, gate in enumerate(layer):
        w = (alpha * equ[g] + beta * eqv[g]) % p
        idx = gate.a + (gate.b << ku)
        if gate.op == ADD:
            A[idx] = (A[idx] + w) % p
        else:
            M[idx] = (M[idx] + w) % p
    return MultiLin(A, p), MultiLin(M, p)


def _wiring_eval(api_or_p, layer, u, v, alpha, beta, xpt, ypt, in_circuit=False, api=None):
    """Evaluate (A, M) at the final sumcheck point — the verifier-computed
    wiring oracle: Σ_g (alpha eq(u,g)+beta eq(v,g)) eq(xpt,a_g) eq(ypt,b_g).
    Host (in_circuit=False) or in-circuit over variables u,v,xpt,ypt."""
    if not in_circuit:
        p = api_or_p
        A = M = 0
        for g, gate in enumerate(layer):
            w = (alpha * _eq_point_gate(u, g, p) + beta * _eq_point_gate(v, g, p)) % p
            w = w * _eq_point_gate(xpt, gate.a, p) % p
            w = w * _eq_point_gate(ypt, gate.b, p) % p
            if gate.op == ADD:
                A = (A + w) % p
            else:
                M = (M + w) % p
        return A, M

    # in-circuit: challenges are circuit vars, gate indices are constants
    def eqc(point, g):
        acc = 1
        for j, w in enumerate(point):
            term = w if (g >> j) & 1 else api.sub(1, w)
            acc = api.mul(acc, term)
        return acc

    A = 0
    M = 0
    for g, gate in enumerate(layer):
        w = api.add(api.mul(alpha, eqc(u, g)), api.mul(beta, eqc(v, g)))
        w = api.mul(w, api.mul(eqc(xpt, gate.a), eqc(ypt, gate.b)))
        if gate.op == ADD:
            A = api.add(A, w)
        else:
            M = api.add(M, w)
    return A, M


def _dot(a, b, p):
    return sum(x * y for x, y in zip(a, b)) % p


# ------------------------------------------------------------------- prover
def prove(circuit: LayeredCircuit, inputs: list[int], p: int):
    """Returns (outputs, GkrProof). Transcript binds the outputs, so the
    proof attests: these outputs = circuit(inputs)."""
    layer_vals = circuit.evaluate(inputs, p)
    outputs = layer_vals[0]

    tr = Transcript(p)
    tr.absorb(*outputs)

    k0 = _kvars(len(circuit.layers[0]))
    z = tr.challenges(k0)
    u, v, alpha, beta = z, z, 1, 0
    claim = _dot(eq_table(z, p).e, _pad(outputs, k0), p)

    proofs = []
    for i, layer in enumerate(circuit.layers):
        deeper = layer_vals[i + 1] if i + 1 < len(layer_vals) else [x % p for x in inputs]
        ku = _kvars(len(deeper))
        W = _pad(deeper, ku)

        equ = eq_table(u, p).e
        eqv = eq_table(v, p).e
        A, M = _wiring_tables(layer, ku, alpha, beta, equ, eqv, p)

        size = 1 << (2 * ku)
        Wx = MultiLin([W[j & ((1 << ku) - 1)] for j in range(size)], p)
        Wy = MultiLin([W[j >> ku] for j in range(size)], p)

        rounds, point, _ = prove_terms([[A, Wx], [A, Wy], [M, Wx, Wy]], claim, p, tr)
        xpt, ypt = point[:ku], point[ku:]
        wu = _dot(eq_table(xpt, p).e, W, p)
        wv = _dot(eq_table(ypt, p).e, W, p)
        proofs.append(LayerProof(rounds, wu, wv))

        tr.absorb(wu, wv)
        if i + 1 < len(circuit.layers):
            alpha, beta = tr.challenge(), tr.challenge()
            u, v = xpt, ypt
            claim = (alpha * wu + beta * wv) % p
        else:
            u, v = xpt, ypt  # final input-layer claims

    return outputs, GkrProof(proofs)


# ----------------------------------------------------------------- verifier
def verify(circuit: LayeredCircuit, inputs: list[int], outputs: list[int],
           proof: GkrProof, p: int):
    """Host verifier: recomputes wiring oracles per layer; checks the final
    claims against the input multilinear extension. Raises on failure."""
    tr = Transcript(p)
    tr.absorb(*outputs)
    k0 = _kvars(len(circuit.layers[0]))
    z = tr.challenges(k0)
    u, v, alpha, beta = z, z, 1, 0
    claim = _dot(eq_table(z, p).e, _pad(outputs, k0), p)

    for i, (layer, lp) in enumerate(zip(circuit.layers, proof.layers, strict=True)):
        n_deep = len(circuit.layers[i + 1]) if i + 1 < len(circuit.layers) else circuit.n_inputs
        ku = _kvars(n_deep)
        point, expected = verify_rounds(claim, lp.rounds, 3, p, tr)
        if len(point) != 2 * ku:
            raise ValueError("wrong round count")
        xpt, ypt = point[:ku], point[ku:]
        A, M = _wiring_eval(p, layer, u, v, alpha, beta, xpt, ypt)
        got = (A * ((lp.wu + lp.wv) % p) + M * lp.wu % p * lp.wv) % p
        if got != expected:
            raise ValueError(f"GKR layer {i} oracle mismatch")
        tr.absorb(lp.wu, lp.wv)
        if i + 1 < len(circuit.layers):
            alpha, beta = tr.challenge(), tr.challenge()
            u, v = xpt, ypt
            claim = (alpha * lp.wu + beta * lp.wv) % p
        else:
            # input layer: evaluate the input MLE directly
            kin = _kvars(circuit.n_inputs)
            W = _pad([x % p for x in inputs], kin)
            if _dot(eq_table(xpt, p).e, W, p) != lp.wu:
                raise ValueError("input MLE mismatch (u)")
            if _dot(eq_table(ypt, p).e, W, p) != lp.wv:
                raise ValueError("input MLE mismatch (v)")
    return True


# ------------------------------------------------------------- circuit side
def verify_in_circuit(api, circuit: LayeredCircuit, input_vars, output_vars,
                      proof: GkrProof):
    """In-circuit GKR verifier (std/gkr's verification half): input/output
    wires are circuit variables; the proof's rounds/claims enter as witness
    variables supplied by the caller (typically via hints). Constrains the
    whole transcript."""
    p = api.p
    tr = Transcript(p, api=api)
    tr.absorb(*output_vars)
    k0 = _kvars(len(circuit.layers[0]))
    z = tr.challenges(k0)
    u, v, alpha, beta = z, z, 1, 0

    def mle_eval(point, vals):
        # Σ_g eq(point, g) * vals[g] with g constant bits
        acc = 0
        for g, val in enumerate(vals):
            eqg = 1
            for j, w in enumerate(point):
                term = w if (g >> j) & 1 else api.sub(1, w)
                eqg = api.mul(eqg, term)
            acc = api.add(acc, api.mul(eqg, val))
        return acc

    claim = mle_eval(z, output_vars)

    for i, (layer, lp) in enumerate(zip(circuit.layers, proof.layers, strict=True)):
        n_deep = len(circuit.layers[i + 1]) if i + 1 < len(circuit.layers) else circuit.n_inputs
        ku = _kvars(n_deep)
        point, expected = verify_rounds_in_circuit(api, claim, lp.rounds, 3, tr)
        assert len(point) == 2 * ku
        xpt, ypt = point[:ku], point[ku:]
        A, M = _wiring_eval(None, layer, u, v, alpha, beta, xpt, ypt,
                            in_circuit=True, api=api)
        got = api.add(api.mul(A, api.add(lp.wu, lp.wv)),
                      api.mul(M, api.mul(lp.wu, lp.wv)))
        api.assert_is_equal(got, expected)
        tr.absorb(lp.wu, lp.wv)
        if i + 1 < len(circuit.layers):
            alpha, beta = tr.challenge(), tr.challenge()
            u, v = xpt, ypt
            claim = api.add(api.mul(alpha, lp.wu), api.mul(beta, lp.wv))
        else:
            api.assert_is_equal(mle_eval(xpt, input_vars), lp.wu)
            api.assert_is_equal(mle_eval(ypt, input_vars), lp.wv)
    return True
