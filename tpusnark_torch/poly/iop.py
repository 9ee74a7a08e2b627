"""iop-style polynomial abstraction: (basis, layout) tracked with the data
(counterpart of tpusnark/poly/iop.py, on torch tensors).

gnark-crypto's `iop` package (consumed throughout the reference PLONK prover,
gnark/backend/plonk/bn254/prove.go:40,565-567,610-621,1000-1017) wraps every
polynomial in a `Polynomial{Basis, Layout}` pair and converts lazily between
them (Canonical <-> Lagrange <-> LagrangeCoset, Regular <-> BitReverse).
This module is an immutable wrapper over a (words, n) Montgomery word tensor
plus explicit metadata; conversions run the port's NTT on the tensor's
device.

Conventions match poly/ntt.py:
  CANONICAL  regular   = coefficient vector c_0..c_{n-1}
  LAGRANGE   regular   = evaluations on <w> in natural order w^0..w^{n-1}
  LAGRANGE_COSET       = evaluations on shift*<w>, natural order
BIT_REVERSE layout stores the same values permuted by bit_reverse_perm(n).

`shift(k)` is lazy, like gnark-crypto's `Shift`: it records a cyclic offset
applied on materialization (valid in a Lagrange-type basis where shifting
evaluations by k rotates the domain: p(w^{i+k})).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, replace

import torch

from ..fields.spec import FieldSpec
from ..fields.tfield import Field, compute_device, get_field
from .domain import bit_reverse_perm
from .ntt import get_ntt


class Basis(enum.Enum):
    CANONICAL = "canonical"
    LAGRANGE = "lagrange"
    LAGRANGE_COSET = "lagrange_coset"


class Layout(enum.Enum):
    REGULAR = "regular"
    BIT_REVERSE = "bit_reverse"


@dataclass(frozen=True)
class Polynomial:
    """Immutable (data, basis, layout, lazy-shift) bundle.

    data: (words, n) Montgomery int32 words, on the device it computes on.
    shift_k: pending cyclic evaluation shift (Lagrange bases only).
    """

    data: torch.Tensor
    basis: Basis
    layout: Layout
    spec: FieldSpec
    shift_k: int = 0

    # ------------------------------------------------------------- properties
    @property
    def n(self) -> int:
        return self.data.shape[-1]

    @property
    def field(self) -> Field:
        return get_field(self.spec)

    def _ntt(self):
        return get_ntt(self.spec, self.n, self.data.device)

    # ------------------------------------------------------------ constructors
    @classmethod
    def from_ints(
        cls,
        values,
        spec: FieldSpec,
        basis: Basis = Basis.CANONICAL,
        layout: Layout = Layout.REGULAR,
        device="cuda",
    ) -> "Polynomial":
        """Encoded on `device`: the card, unless the caller names the CPU."""
        f = get_field(spec)
        return cls(f.encode(list(values), device=compute_device(device)), basis, layout, spec)

    def to_ints(self) -> list[int]:
        """Materialize (applying any lazy shift) and decode to python ints."""
        p = self.materialize()
        return p.field.decode(p.data)

    # --------------------------------------------------------------- layout
    def _permuted(self, layout: Layout) -> "Polynomial":
        br = torch.from_numpy(bit_reverse_perm(self.n)).to(self.data.device)
        return replace(self, data=self.data.index_select(-1, br), layout=layout)

    def to_regular(self) -> "Polynomial":
        if self.layout is Layout.REGULAR:
            return self
        return self._permuted(Layout.REGULAR)

    def to_bit_reverse(self) -> "Polynomial":
        if self.layout is Layout.BIT_REVERSE:
            return self
        return self._permuted(Layout.BIT_REVERSE)

    # ---------------------------------------------------------------- shift
    def shift(self, k: int) -> "Polynomial":
        """Lazy cyclic shift: the result's evaluation i is p(w^{i+k}).
        Only meaningful in a Lagrange-type basis (gnark-crypto iop.Shift)."""
        assert self.basis is not Basis.CANONICAL, "shift needs evaluations"
        return replace(self, shift_k=(self.shift_k + k) % self.n)

    def materialize(self) -> "Polynomial":
        """Apply any pending shift as an actual roll of the data."""
        if self.shift_k == 0:
            return self
        p = self.to_regular()
        data = torch.roll(p.data, -p.shift_k, dims=-1)
        return replace(p, data=data, shift_k=0)

    # ---------------------------------------------------------------- basis
    def to_canonical(self) -> "Polynomial":
        p = self.materialize().to_regular()
        if p.basis is Basis.CANONICAL:
            return p
        ntt = p._ntt()
        if p.basis is Basis.LAGRANGE:
            data = ntt.intt(p.data)
        else:  # LAGRANGE_COSET
            data = ntt.intt_coset(p.data)
        return replace(p, data=data, basis=Basis.CANONICAL)

    def to_lagrange(self) -> "Polynomial":
        p = self.materialize()
        if p.basis is Basis.LAGRANGE:
            return p
        p = p.to_canonical()
        return replace(p, data=p._ntt().ntt(p.data), basis=Basis.LAGRANGE)

    def to_lagrange_coset(self) -> "Polynomial":
        p = self.materialize()
        if p.basis is Basis.LAGRANGE_COSET:
            return p
        p = p.to_canonical()
        return replace(p, data=p._ntt().ntt_coset(p.data), basis=Basis.LAGRANGE_COSET)

    # ------------------------------------------------------------ arithmetic
    def _aligned(self, other: "Polynomial") -> tuple["Polynomial", "Polynomial"]:
        assert self.spec == other.spec and self.n == other.n
        a, b = self.materialize(), other.materialize()
        assert a.basis is b.basis, f"basis mismatch: {a.basis} vs {b.basis}"
        if a.layout is not b.layout:
            b = b.to_regular() if a.layout is Layout.REGULAR else b.to_bit_reverse()
        return a, b

    def add(self, other: "Polynomial") -> "Polynomial":
        a, b = self._aligned(other)
        return replace(a, data=a.field.add(a.data, b.data))

    def sub(self, other: "Polynomial") -> "Polynomial":
        a, b = self._aligned(other)
        return replace(a, data=a.field.sub(a.data, b.data))

    def mul(self, other: "Polynomial") -> "Polynomial":
        """Pointwise product — evaluations only (canonical would be a
        convolution; convert explicitly if that is what you mean)."""
        assert self.basis is not Basis.CANONICAL
        a, b = self._aligned(other)
        return replace(a, data=a.field.mul(a.data, b.data))

    def scale(self, c: int) -> "Polynomial":
        p = self.materialize()
        return replace(p, data=p.field.mul_const(p.data, int(c) % p.spec.modulus))

    # ------------------------------------------------------------- evaluation
    def evaluate(self, x: int) -> int:
        """p(x) over host ints (verifier-scale op, not a hot path)."""
        coeffs = self.to_canonical().to_ints()
        p_mod = self.spec.modulus
        acc = 0
        for c in reversed(coeffs):
            acc = (acc * x + c) % p_mod
        return acc
