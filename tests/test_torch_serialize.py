"""The port's constraint-system serialization and witness container
(``constraint/serialize.py``, ``backend/witness.py``) against tpusnark's:
the copied functions are tpusnark's code; an R1CS with hints and a BSB22
commitment and an SCS dump to tpusnark's bytes; tpusnark's bytes load in
the port and solve to the same witness (and the port's in tpusnark);
Witness bytes, their public part and the reference's golden vector are
equal."""

import pytest
import torch

import tpusnark.backend.witness as jwit
import tpusnark.constraint.scs as jscs
import tpusnark.constraint.serialize as jser
import tpusnark.constraint.solver as jsolver
import tpusnark.frontend.builder as jbuilder
import tpusnark.frontend.plonk_builder as jpb
import tpusnark_torch.backend.witness as twit
import tpusnark_torch.constraint.scs as tscs
import tpusnark_torch.constraint.serialize as tser
import tpusnark_torch.constraint.solver as tsolver
import tpusnark_torch.frontend.builder as tbuilder
import tpusnark_torch.frontend.plonk_builder as tpb
from tests.test_torch_host import code_without_docstrings, cs_image, scs_image
from tpusnark_torch.fields.spec import BN254_FR

torch.set_num_threads(1)  # the suite's workers fill the cores already

P = BN254_FR.modulus

COPIES = (
    "MAGIC",
    "r1cs_to_dict",
    "r1cs_from_dict",
    "scs_to_dict",
    "scs_from_dict",
    "dump",
    "load",
)


@pytest.mark.parametrize("name", COPIES)
def test_serialize_functions_are_tpusnark_code(name):
    ours, theirs = getattr(tser, name), getattr(jser, name)
    if isinstance(ours, bytes):
        assert ours == theirs
    else:
        assert code_without_docstrings(ours) == code_without_docstrings(theirs)


def test_witness_module_is_tpusnark_code():
    assert code_without_docstrings(twit) == code_without_docstrings(jwit)


def r1cs(mod):
    """An R1CS through the bit-decomposition, inverse and BSB22 hints."""
    b = mod.Builder(P)
    x, y = b.secret("x"), b.public("y")
    bits = b.to_binary(x, 8)
    even = b.is_zero(bits[0])
    c = b.commit(x, even)
    b.assert_is_different(c, x)
    b.assert_is_equal(b.add(b.mul(x, x), even, b.inverse(b.add(x, 1)), b.mul(0, c)), y)
    return b.compile()


def scs(mod):
    b = mod.PlonkBuilder(P)
    x, y = b.secret("x"), b.public("y")
    bits = b.to_binary(x, 8)
    even = b.is_zero(bits[0])
    b.assert_is_equal(b.add(b.mul(x, x), even, b.div(x, 3)), y)
    return b.compile()


def r1cs_assign():
    return {"x": 6, "y": (36 + 1 + pow(7, -1, P)) % P}


def scs_assign():
    return {"x": 6, "y": (36 + 1 + 2) % P}


def test_r1cs_dumps_to_tpusnark_bytes_and_loads_across():
    ours, theirs = r1cs(tbuilder), r1cs(jbuilder)
    blob = tser.dump(ours)
    assert blob == jser.dump(theirs)
    assert any(i[0] == "hint" for i in ours.instructions) and len(ours.commitments) == 1
    mine, yours = tser.load(jser.dump(theirs)), jser.load(blob)
    assert cs_image(mine) == cs_image(ours) and cs_image(yours) == cs_image(theirs)
    assert [c.__dict__ for c in mine.commitments] == [c.__dict__ for c in theirs.commitments]
    assert tser.dump(mine) == blob
    want = jsolver.solve(theirs, r1cs_assign())
    assert tsolver.solve(mine, r1cs_assign()) == want == jsolver.solve(yours, r1cs_assign())
    with pytest.raises(tsolver.UnsatisfiedConstraintError):
        tsolver.solve(mine, dict(r1cs_assign(), y=1))


def test_scs_dumps_to_tpusnark_bytes_and_loads_across():
    ours, theirs = scs(tpb), scs(jpb)
    blob = tser.dump(ours)
    assert blob == jser.dump(theirs)
    mine = tser.load(jser.dump(theirs))
    assert scs_image(mine) == scs_image(ours)
    assert tscs.solve_scs(mine, scs_assign()) == jscs.solve_scs(theirs, scs_assign())
    assert jscs.solve_scs(jser.load(blob), scs_assign()) == jscs.solve_scs(theirs, scs_assign())
    with pytest.raises(ValueError, match="not a tpusnark constraint system"):
        tser.load(b"GNARK" + blob)


def test_hint_names_take_the_reference_form():
    """A hint of the port is written under tpusnark's module path and read
    back as the port's function; a name of another module passes as it is."""
    from tpusnark_torch.constraint import hints

    name = tser.register_hint(hints.inv_hint)
    assert name == "tpusnark.constraint.hints.inv_hint"
    assert tser.get_hint(name) is hints.inv_hint
    assert tser.get_hint("tpusnark_torch.constraint.hints.inv_hint") is hints.inv_hint

    def local_hint(p, ins):
        return ins

    key = tser.register_hint(local_hint)
    assert key == hints.hint_name(local_hint) and tser.get_hint(key) is local_hint


def test_witness_bytes_and_public_part_equal_tpusnark():
    for cs_t, cs_j, assign in ((r1cs(tbuilder), r1cs(jbuilder), r1cs_assign()), (scs(tpb), scs(jpb), scs_assign())):
        ours = twit.Witness.from_assignment(cs_t, assign)
        theirs = jwit.Witness.from_assignment(cs_j, assign)
        assert ours.to_bytes() == theirs.to_bytes()
        assert ours.public().to_bytes() == theirs.public().to_bytes()
        back = twit.Witness.from_bytes(theirs.to_bytes())
        assert (back.n_public, back.n_secret, back.values) == (theirs.n_public, theirs.n_secret, theirs.values)
        assert back.to_assignment(cs_t) == jwit.Witness.from_bytes(ours.to_bytes()).to_assignment(cs_j)
    # the reference's golden vector (witness.go:33-36): Y = 35 public, X = 3, Z = 2 secret
    golden = twit.Witness(n_public=1, n_secret=2, values=[35, 3, 2]).to_bytes()
    assert golden == jwit.Witness(n_public=1, n_secret=2, values=[35, 3, 2]).to_bytes()
    assert golden.hex().startswith("000000010000000200000003" + "00" * 31 + "23")
    with pytest.raises(ValueError, match="length mismatch"):
        twit.Witness.from_bytes(golden[:8] + (4).to_bytes(4, "big") + golden[12:] + bytes(32))
