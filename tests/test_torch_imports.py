"""The port stands alone: every module of tpusnark_torch and chip_smoke.py
import, and a tiny Groth16 setup and prove run per curve family (G2 over
Fp2: BLS12-377; over Fp: BW6-761 and BW6-633; over Fp4: BLS24-315 and
BLS24-317), in a process where neither ``jax`` nor the JAX package
``tpusnark`` can be imported. chip_smoke.py exits non-zero, with no result
line, where there is no CUDA device and where it stands alone."""

import inspect
import os
import re
import shutil
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# any import of jax or of tpusnark raises ImportError from here on
BLOCK = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.modules["tpusnark"] = None
    sys.path.insert(0, {root!r})
    """
)

IMPORT_ALL = BLOCK + textwrap.dedent(
    """
    import importlib, pkgutil
    import tpusnark_torch
    names = [m.name for m in pkgutil.walk_packages(tpusnark_torch.__path__, "tpusnark_torch.")]
    for name in names:
        importlib.import_module(name)
    from tpusnark_torch.backend.groth16 import prove, setup, verify
    from tpusnark_torch.backend import plonk
    import chip_smoke
    for name in ("backend.groth16.prove", "backend.groth16.verify", "backend.groth16.bls381",
                 "curves.ref", "curves.bls12381", "curves.bls12377", "curves.bw6761",
                 "curves.tower", "curves.bls24", "curves.bls24315", "curves.bls24317", "curves.bw6633",
                 "constraint.solver", "constraint.solver_torch", "curves.pedersen", "curves.marshal",
                 "utils.hash_to_field", "frontend.builder", "fields.spec", "poly.domain",
                 "utils.transcript", "constraint.scs", "frontend.plonk_builder", "poly.scan", "poly.iop",
                 "poly.kzg", "backend.plonk.keys", "backend.plonk.setup", "backend.plonk.prove",
                 "backend.plonk.verify", "curves.hash_to_g2", "backend.groth16.mpcsetup",
                 "backend.groth16.marshal", "backend.groth16.solidity", "backend.plonk.marshal",
                 "backend.plonk.solidity", "parallel.sharding", "parallel.dryrun", "backend.groth16.sharded",
                 "backend.plonk.sharded", "logger", "hashes.keccak", "hashes.mimc", "curves.edwards",
                 "gadgets.merkle", "gadgets.twistededwards", "gadgets.eddsa", "gadgets.uints", "gadgets.sha2",
                 "examples.cubic", "examples.exponentiate", "examples.mimc", "examples.plonk_example",
                 "examples.rollup", "testing.engine", "gadgets.bits", "gadgets.cmp", "gadgets.selector",
                 "gadgets.bitslice", "gadgets.multicommit", "gadgets.lookup", "gadgets.rangecheck",
                 "gadgets.keccakf", "gadgets.sha3", "utils.mimc_transcript", "gadgets.native_tower",
                 "gadgets.sw_native", "gadgets.recursion_native", "gadgets.emulated", "gadgets.sw_emulated",
                 "gadgets.fields_tower", "gadgets.pairing", "gadgets.recursion", "gadgets.kzg_verifier",
                 "gadgets.recursion_plonk", "gadgets.evmprecompiles", "protocols", "protocols.multilinear",
                 "protocols.sumcheck", "protocols.gkr", "gadgets.gkr_compile", "poly.fri", "backend.plonkfri",
                 "backend.plonkfri.scheme", "constraint.serialize", "backend.witness", "stats",
                 "testing.circuits", "testing.gobstats", "testing.solidity_exec"):
        assert "tpusnark_torch." + name in names, name
    assert "tpusnark_torch._host" not in names
    assert sys.modules["jax"] is None and sys.modules["tpusnark"] is None
    assert not [m for m in sys.modules if m.startswith(("jax.", "tpusnark."))]
    print("imported", len(names))
    """
)

# One curve's path at a tiny size: curve ops, MSM, NTT, then (where `groth16`
# says so) setup, prove and (where `verify` says so) the port's verifier,
# through the entry points.
PATH = BLOCK + textwrap.dedent(
    """
    import random
    from tpusnark_torch.backend.groth16 import InvalidProofError, prove, setup, verify
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.curves.encoding import g1_from_device_proj, g1_to_device
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.frontend.builder import Builder
    from tpusnark_torch.msm.pippenger import get_msm
    from tpusnark_torch.poly.ntt import get_ntt

    curve = {curve!r}
    cfg = get_curve(curve)
    host, fp, fr = cfg.host, get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    g1, g2 = curve_ops(curve)
    assert (g1.group, g2.group, g2.degree) == ("g1", "g2", 1 if cfg.g2_over_fp else 4 if cfg.g2_fp4 else 2)
    pts = [host.G1.generator(), None, host.G1.mul(host.G1.generator(), 3)]
    out = get_msm("g1", 4, curve)(g1_to_device(pts, fp), fr.encode([5, 7, 0], mont=False))
    assert g1_from_device_proj(out, fp) == [host.G1.mul(host.G1.generator(), 5)]
    ntt = get_ntt(cfg.fr_spec, 8, "cpu")
    assert ntt.field.decode(ntt.intt(ntt.ntt(fr.encode(list(range(8)))))) == list(range(8))

    if not {groth16}:
        print(curve, "ok")
        raise SystemExit(0)
    b = Builder(host.R)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    cs = b.compile()
    rng = random.Random(1)
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, host.R), device="cpu", curve=curve)
    proof = prove(cs, pk, {{"x": 3, "y": 35}}, rng=lambda: rng.randrange(host.R), device="cpu")
    assert host.G1.in_subgroup(proof.ar) and host.G2.in_subgroup(proof.bs)
    if {verify}:
        assert verify(proof, vk, [35], curve=curve)
        assert not verify(proof, vk, [36], curve=curve)
    else:  # the checks ahead of the pairing
        try:
            verify(proof, vk, [35, 36], curve=curve)
            raise SystemExit("a wrong count of public inputs passed")
        except InvalidProofError:
            pass
    assert sys.modules["jax"] is None and sys.modules["tpusnark"] is None
    print(curve, "ok")
    """
)


def _path(curve, groth16=True, verify=True):
    return PATH.format(root=ROOT, curve=curve, groth16=groth16, verify=verify)


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # the suite's workers fill the cores already
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=900)


def test_port_imports_without_jax():
    res = _run([sys.executable, "-c", IMPORT_ALL.format(root=ROOT)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("imported")


def test_fp2_g2_path_runs_without_jax_and_tpusnark():
    """BLS12-377 (G2 over Fp2, u^2 = -5): setup, prove and the port's
    verifier, which accepts the proof and rejects a wrong public input."""
    res = _run([sys.executable, "-c", _path("bls12-377")], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "bls12-377 ok"


def test_bls12381_path_runs_without_jax():
    """BLS12-381 (9-word scalars): curve ops, MSM and NTT; its Groth16 path
    runs in tests/test_torch_groth16.py."""
    res = _run([sys.executable, "-c", _path("bls12-381", groth16=False)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "bls12-381 ok"


def test_fp_g2_path_runs_without_jax_and_tpusnark():
    """BW6-761 (G2 over Fp, 24-word coordinates): setup and prove. A BW6-761
    pairing check is four Miller loops of a minute each in Python integers,
    so here the verifier runs as far as its checks ahead of the pairing; the
    proof itself is verified in tests/test_torch_groth16_bw6.py and, by the
    port's verifier, on the card by chip_smoke.py."""
    res = _run([sys.executable, "-c", _path("bw6-761", verify=False)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "bw6-761 ok"


@pytest.mark.parametrize("curve", ("bls24-315", "bls24-317", "bw6-633"))
def test_bls24_and_bw6633_paths_run_without_jax_and_tpusnark(curve):
    """BLS24-315 and BLS24-317 (G2 over Fp4) and BW6-633 (20-word Fp): curve
    ops, MSM and NTT here; their Groth16 setup and prove run without jax and
    tpusnark in groth16_without_jax, the module fixture of
    tests/test_torch_bls24.py and tests/test_torch_bw6633.py, whose tests
    hold the keys and the proof against tpusnark."""
    res = _run([sys.executable, "-c", _path(curve, groth16=False)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == f"{curve} ok"


# Setup and prove of the cubic circuit over `curve`, seeded as the Groth16
# tests seed tpusnark's, pickled to `out` as chip_smoke.portable makes them
# (the Fp4 tower's classes are made at run time and do not pickle).
GROTH16 = BLOCK + textwrap.dedent(
    """
    import pickle, random
    from chip_smoke import portable
    from tpusnark_torch.backend.groth16 import prove, setup
    from tpusnark_torch.curves.config import get_curve
    from tpusnark_torch.frontend.builder import Builder
    curve = {curve!r}
    host = get_curve(curve).host
    b = Builder(host.R)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    cs = b.compile()
    rng, prng = random.Random(42), random.Random(7)
    pk, vk = setup(cs, rng=lambda: rng.randrange(1, host.R), device="cpu", curve=curve)
    timings = {{}}
    proof = prove(cs, pk, {{"x": 3, "y": 35}}, rng=lambda: prng.randrange(host.R), timings=timings, device="cpu")
    assert sys.modules["jax"] is None and sys.modules["tpusnark"] is None
    with open({out!r}, "wb") as f:
        pickle.dump(portable((pk, vk, proof, sorted(timings))), f)
    """
)


def groth16_without_jax(curve, tmp_dir):
    """(pk, vk, proof, phase names) of the port's setup and prove of the
    cubic circuit over `curve` (rngs seeded 42 and 7), computed in a process
    where jax and tpusnark cannot be imported; the host points are the port's
    own classes again."""
    import pickle

    import chip_smoke
    from tpusnark_torch.curves.config import get_curve

    out = os.path.join(str(tmp_dir), f"groth16-{curve}.pickle")
    res = _run([sys.executable, "-c", GROTH16.format(root=ROOT, curve=curve, out=out)], ROOT)
    assert res.returncode == 0, res.stderr
    with open(out, "rb") as f:
        return chip_smoke.restored(pickle.load(f), get_curve(curve).host)


# PLONK setup and prove over BN254 on the CPU, seeded as tpusnark's PLONK
# tests seed tpusnark's, pickled to `out`: the keys (their tensors on the
# CPU), the proof and the phase names.
PLONK = BLOCK + textwrap.dedent(
    """
    import pickle, random
    from tpusnark_torch.backend import plonk
    from tpusnark_torch.fields.spec import BN254_FR
    from tpusnark_torch.frontend.plonk_builder import PlonkBuilder
    P = BN254_FR.modulus
    """
)


def start_plonk_without_jax(circuit, assignment, public, tau, seed, tmp_dir):
    """Start the port's PLONK setup (SRS from `tau`), prove (rng
    random.Random(seed).randrange(1, r)) and verify (with the public inputs
    `public`, and a wrong one) of `circuit(PlonkBuilder, r)` in a process
    where jax and tpusnark cannot be imported; returns a function that waits
    for it and gives (pk, vk, proof, phase names)."""
    import pickle

    out = os.path.join(str(tmp_dir), f"plonk-{circuit.__name__}.pickle")
    script = PLONK.format(root=ROOT) + textwrap.dedent(inspect.getsource(circuit)) + textwrap.dedent(
        f"""
        cs = {circuit.__name__}(PlonkBuilder, P)
        pk, vk = plonk.setup(cs, tau={tau}, device="cpu")
        rng, timings = random.Random({seed}), {{}}
        proof = plonk.prove(cs, pk, {assignment!r}, rng=lambda: rng.randrange(1, P), timings=timings)
        assert plonk.verify(proof, vk, {public!r})
        assert not plonk.verify(proof, vk, {[v + 1 for v in public]!r})
        assert sys.modules["jax"] is None and sys.modules["tpusnark"] is None
        with open({out!r}, "wb") as f:
            pickle.dump((pk, vk, proof, sorted(timings)), f)
        """
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    proc = subprocess.Popen(
        [sys.executable, "-c", script], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
    )

    def wait():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, err
        with open(out, "rb") as f:
            return pickle.load(f)

    return wait


# The ceremony at power 2 through the port's entry points: init, one
# phase-1 contribution held by chip_smoke.py's phase-10 lane checks, one
# phase-2 contribution, both links verified, extract_keys, a prove and its
# verdicts.
CEREMONY = BLOCK + textwrap.dedent(
    """
    import copy, random
    import torch
    import chip_smoke
    from tpusnark_torch.backend.groth16 import mpcsetup, prove, verify
    from tpusnark_torch.curves.ref import R
    from tpusnark_torch.frontend.builder import Builder
    cpu = torch.device("cpu")
    p1_init = mpcsetup.init_phase1(2)
    p1, draws = copy.deepcopy(p1_init), []
    p1.contribute(chip_smoke.ceremony_rng(1, draws), device="cpu")
    mpcsetup.verify_phase1(p1_init, p1)
    chip_smoke.check_phase1_lanes(torch, cpu, p1, *draws[:3], "power 2", 5)
    b = Builder(R)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    cs = b.compile()
    p2_init, evals = mpcsetup.init_phase2(cs, p1)
    p2 = copy.deepcopy(p2_init)
    p2.contribute(chip_smoke.ceremony_rng(2, []), device="cpu")
    mpcsetup.verify_phase2(p2_init, p2)
    pk, vk = mpcsetup.extract_keys(cs, p1, p2, evals)
    rng = random.Random(3)
    proof = prove(cs, pk, {{"x": 3, "y": 35}}, rng=lambda: rng.randrange(R), device="cpu")
    assert verify(proof, vk, [35]) and not verify(proof, vk, [36])
    assert sys.modules["jax"] is None and sys.modules["tpusnark"] is None
    print("ceremony ok")
    """
)


# The last modules at a tiny size: a PlonkFRI setup, prove and verify on the
# CPU, the serialized system proving the same proof, the stats baseline, a
# GKR proof and its verifier, and one corpus entry through the engine.
LAST_MODULES = BLOCK + textwrap.dedent(
    """
    from tpusnark_torch.backend import plonkfri
    from tpusnark_torch.backend.witness import Witness
    from tpusnark_torch.constraint import serialize
    from tpusnark_torch.frontend.plonk_builder import PlonkBuilder
    from tpusnark_torch.poly.fri import FriParams
    from tpusnark_torch.protocols import gkr
    from tpusnark_torch import stats
    from tpusnark_torch.testing.circuits import CORPUS
    from tpusnark_torch.testing.engine import is_solved

    from tpusnark_torch.fields.spec import BN254_FR

    p = BN254_FR.modulus
    b = PlonkBuilder(p)
    x, y = b.secret("x"), b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    cs = b.compile()
    pk, vk = plonkfri.setup(cs, FriParams(8, 8, 4), device="cpu")
    proof = plonkfri.prove(cs, pk, {{"x": 3, "y": 35}}, device="cpu")
    assert plonkfri.verify(proof, vk, [35]) and not plonkfri.verify(proof, vk, [36])
    again = plonkfri.prove(serialize.load(serialize.dump(cs)), pk, {{"x": 3, "y": 35}}, device="cpu")
    assert again == proof
    w = Witness.from_assignment(cs, {{"x": 3, "y": 35}})
    assert Witness.from_bytes(w.to_bytes()) == w
    assert stats.check_against_baseline() == []
    c = gkr.LayeredCircuit([[gkr.Gate(gkr.MUL, 0, 1), gkr.Gate(gkr.ADD, 0, 1)]], n_inputs=2)
    outs, gproof = gkr.prove(c, [3, 5], p)
    assert outs == [15, 8] and gkr.verify(c, [3, 5], outs, gproof, p)
    assert all(is_solved(CORPUS["cubic"].define, p, a) for a in CORPUS["cubic"].valid)
    assert sys.modules["jax"] is None and sys.modules["tpusnark"] is None
    assert not [m for m in sys.modules if m.startswith(("jax.", "tpusnark."))]
    print("last modules ok")
    """
)


def test_last_modules_run_without_jax_and_tpusnark():
    res = _run([sys.executable, "-c", LAST_MODULES.format(root=ROOT)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("last modules ok")


def test_ceremony_runs_without_jax_and_tpusnark():
    res = _run([sys.executable, "-c", CEREMONY.format(root=ROOT)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ceremony ok")
    assert "every lane of the four lists" in res.stdout


def test_the_port_and_chip_smoke_name_no_tpusnark_import():
    """No source line of the port or of chip_smoke.py imports tpusnark."""
    pattern = re.compile(r"^\s*(from|import) +tpusnark(\.| |$)", re.M)
    paths = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _, files in os.walk(os.path.join(ROOT, "tpusnark_torch")):
        paths += [os.path.join(base, f) for f in files if f.endswith(".py")]
    assert len(paths) > 30
    bad = [p for p in paths if pattern.search(open(p).read())]
    assert not bad
    assert not os.path.exists(os.path.join(ROOT, "tpusnark_torch", "_host.py"))


def test_chip_smoke_fails_without_a_card():
    res = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
