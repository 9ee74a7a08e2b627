"""CS-embedded GKR: the std/gkr compile API analog.

Reference: gnark/std/gkr/compile.go:16-45 + api.go:12 — a circuit
author builds a small Add/Mul DAG over BATCHED instances, imports
per-instance inputs as parent-circuit variables, and gets the outputs back
as variables whose correctness is enforced by an IN-CIRCUIT GKR verifier;
the wire values and the GKR proof itself are computed out-of-circuit by a
solver hint at witness time (gnark defers to SolveHintPlaceholder /
ProveHintPlaceholder, constraint/gkr.go:18-42).

tpusnark shape: the DAG is laid out into protocols.gkr's layered ADD/MUL
form (pass-through identities realized as ADD(w, zero) with a constant-zero
input wire; every layer padded to a power of two; instances replicated
slot-major), one hint computes [padded outputs || flattened proof], and
protocols.gkr.verify_in_circuit pins the whole transcript in constraints.

The port's copy of tpusnark/gadgets/gkr_compile.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..protocols.gkr import (
    ADD,
    MUL,
    Gate,
    GkrProof,
    LayerProof,
    LayeredCircuit,
    _kvars,
    prove,
    verify_in_circuit,
)


def _pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


@dataclass
class GkrApi:
    """Builder for one batched GKR sub-computation inside a parent circuit.

    Usage:
        g = GkrApi()
        a = g.import_input(a_vars)   # one parent var per instance
        b = g.import_input(b_vars)
        c = g.mul(a, b)
        d = g.add(c, a)
        g.output(d)
        outs = g.finalize(parent_builder)   # {wire: [vars per instance]}
    """

    _dag: list = field(default_factory=list)  # ("in",) | (op, a, b)
    _input_vars: list = field(default_factory=list)  # aligned with "in" wires
    _outputs: list = field(default_factory=list)
    n_instances: int | None = None

    def import_input(self, vars_per_instance) -> int:
        vars_per_instance = list(vars_per_instance)
        n = len(vars_per_instance)
        assert n & (n - 1) == 0, "instance count must be a power of two"
        if self.n_instances is None:
            self.n_instances = n
        assert n == self.n_instances, "inconsistent instance counts"
        idx = len(self._dag)
        self._dag.append(("in",))
        self._input_vars.append(vars_per_instance)
        return idx

    def _gate(self, op, a: int, b: int) -> int:
        idx = len(self._dag)
        self._dag.append((op, a, b))
        return idx

    def add(self, a: int, b: int) -> int:
        return self._gate(ADD, a, b)

    def mul(self, a: int, b: int) -> int:
        return self._gate(MUL, a, b)

    def output(self, w: int):
        self._outputs.append(w)

    # ------------------------------------------------------------ layout
    def _layout(self):
        """DAG -> (LayeredCircuit template (per-instance), slot maps)."""
        assert self._outputs, "no outputs declared"
        dag = self._dag
        level = []
        for ent in dag:
            if ent[0] == "in":
                level.append(0)
            else:
                level.append(1 + max(level[ent[1]], level[ent[2]]))
        depth = max(level[w] for w in self._outputs)
        assert depth >= 1, "GKR circuit needs at least one gate"

        # row 0 (deepest) = input wires + a constant-zero slot
        in_wires = [i for i, e in enumerate(dag) if e[0] == "in"]
        rows_slots: list[dict] = [dict((w, j) for j, w in enumerate(in_wires))]
        ZERO = ("zero",)
        rows_slots[0][ZERO] = len(in_wires)
        rows_gates: list[list] = []  # per level 1..depth: list of Gate specs
        for lvl in range(1, depth + 1):
            prev = rows_slots[-1]
            slots: dict = {}
            gates: list[Gate] = []

            def emit(a_slot, b_slot, op):
                gates.append(Gate(op=op, a=a_slot, b=b_slot))
                return len(gates) - 1

            # real gates at this level
            for w, ent in enumerate(dag):
                if ent[0] == "in" or level[w] != lvl:
                    continue
                slots[w] = emit(prev[ent[1]], prev[ent[2]], ent[0])
            # pass-throughs: every prev wire rides along (identity = w + 0)
            zslot = prev[ZERO]
            for key, s in prev.items():
                slots[key] = emit(s, zslot, ADD) if key not in slots else slots[key]
            rows_slots.append(slots)
            rows_gates.append(gates)

        # output row: identities selecting declared outputs, in order
        top = rows_slots[-1]
        zslot = top[ZERO]
        out_gates = [Gate(op=ADD, a=top[w], b=zslot) for w in self._outputs]
        rows_gates.append(out_gates)
        return rows_gates, in_wires

    def finalize(self, api):
        """Lay out, register the prover hint, embed the verifier. Returns
        {output_wire: [out_vars per instance]}."""
        ni = self.n_instances
        rows_gates, in_wires = self._layout()

        # replicate per instance, slot-major: position = slot * ni + inst.
        # A per-instance gate (a, b) at replicated slot s*ni+i reads
        # (a*ni+i, b*ni+i).
        def replicate(gates, width_pad):
            out = []
            for s in range(width_pad):
                for i in range(ni):
                    if s < len(gates):
                        g = gates[s]
                        out.append(Gate(op=g.op, a=g.a * ni + i, b=g.b * ni + i))
                    else:
                        out.append(Gate(op=ADD, a=i, b=i))  # dead pad: 2*w0
            return out

        n_in_slots = _pow2(len(in_wires) + 1)  # + the zero slot
        layers = []
        for gates in rows_gates:
            layers.append(replicate(gates, _pow2(len(gates))))
        # layers currently deepest-first; LayeredCircuit wants outputs first
        layers = layers[::-1]
        circuit = LayeredCircuit(layers=layers, n_inputs=n_in_slots * ni)

        # flat input vars in layout order (zero + pad slots -> constant 0)
        input_vars = []
        for s in range(n_in_slots):
            for i in range(ni):
                if s < len(in_wires):
                    input_vars.append(self._input_vars[s][i])
                else:
                    input_vars.append(0)

        n_out_row = len(layers[0])
        # proof flattening: per layer, 2*ku rounds x 4 evals + wu + wv
        layer_shapes = []
        for li, layer in enumerate(layers):
            n_deep = (
                len(layers[li + 1]) if li + 1 < len(layers) else circuit.n_inputs
            )
            ku = _kvars(n_deep)
            layer_shapes.append(2 * ku)
        n_proof = sum(r * 4 + 2 for r in layer_shapes)

        def gkr_hint(p, ins):
            outputs, proof = prove(circuit, [int(v) for v in ins], p)
            flat = list(outputs)
            for lp in proof.layers:
                for rnd in lp.rounds:
                    flat.extend(rnd)
                flat.extend([lp.wu, lp.wv])
            return [v % p for v in flat]

        from ..frontend.builder import COEFF_ONE, Var

        lin = [api._lin(v) for v in input_vars]
        wires = api.cs.add_hint(gkr_hint, lin, n_out_row + n_proof)
        outs = [Var(((COEFF_ONE, w),)) for w in wires]
        output_vars = list(outs[:n_out_row])
        it = iter(outs[n_out_row:])
        lps = []
        for r in layer_shapes:
            rounds = [[next(it) for _ in range(4)] for _ in range(r)]
            lps.append(LayerProof(rounds=rounds, wu=next(it), wv=next(it)))
        proof_vars = GkrProof(layers=lps)

        verify_in_circuit(api, circuit, input_vars, output_vars, proof_vars)

        # map declared outputs (slot-major layout) back to per-instance vars
        result = {}
        for j, w in enumerate(self._outputs):
            result[w] = [output_vars[j * ni + i] for i in range(ni)]
        return result
