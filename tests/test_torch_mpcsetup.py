"""The MPC ceremony through the port (tpusnark_torch.backend.groth16.mpcsetup,
plain versions on the CPU) against tpusnark's (tests/test_mpcsetup.py).

``VarBaseMul``, the device rescale, is held against tpusnark's (JAX on the
CPU) and the host modules' scalar multiplication. A seeded ceremony at power
3 on tpusnark's cubic circuit runs in both packages, the port once on its
host branch and once with every rescale through ``VarBaseMul`` on CPU
tensors: the transcripts, their hashes and the extracted keys are equal byte
for byte and field for field. tpusnark's verifier accepts a port
contribution to tpusnark's transcript, and both verifiers accept the port's
proof under the ceremony's keys. Then the user's shipping path: the proof
and keys through the port's ``marshal`` (bytes equal to tpusnark's) and the
port's Solidity verifier, run by tpusnark's contract interpreter.
``secrets`` (the initial public keys, which tpusnark draws unseeded) is
seeded for both packages alike."""

import contextlib
import copy
import dataclasses
import random
import secrets
from importlib import import_module
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

import tpusnark.backend.groth16.marshal as jmarshal
import tpusnark.backend.groth16.mpcsetup as jm
import tpusnark.backend.groth16.solidity as jsolidity
import tpusnark.curves.batch_mul as jbm
import tpusnark.curves.encoding as jenc
import tpusnark.curves.jcurve as jcurve
import tpusnark.fields.jfield as jfield
import tpusnark_torch.backend.groth16.marshal as tmarshal
import tpusnark_torch.backend.groth16.mpcsetup as tm
import tpusnark_torch.curves.encoding as tenc
from tpusnark.curves.config import get_curve as jget_curve
from tpusnark.frontend.builder import Builder
from tpusnark.testing.solidity_exec import Contract, ContractRevert
from tpusnark_torch.backend import groth16 as tg16
from tpusnark_torch.curves.batch_mul import VarBaseMul
from tpusnark_torch.curves.config import get_curve
from tpusnark_torch.curves.tcurve import curve_ops
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.frontend.builder import Builder as TBuilder

torch.set_num_threads(1)  # the suite's workers fill the cores already

jverify = import_module("tpusnark.backend.groth16.verify")  # the package's `verify` is the function

R = get_curve("bn254").host.R
ASSIGN = {"x": 3, "y": 35}
PK_FIELDS = ("alpha_g1", "beta_g1", "delta_g1", "beta_g2", "delta_g2", "a", "b1", "b2", "k", "z", "domain_n", "k_wires")
VK_FIELDS = ("alpha_g1", "beta_g2", "gamma_g2", "delta_g2", "k", "beta_g1", "delta_g1")


def cubic(builder):
    """tests/test_mpcsetup.py:_cubic, with either package's builder."""
    b = builder(R)
    x = b.secret("x")
    y = b.public("y")
    x3 = b.mul(x, x, x)
    b.assert_is_equal(b.add(x3, x, 5), y)
    return b.compile()


@contextlib.contextmanager
def seeded_secrets(seed):
    """secrets.randbelow drawn from random.Random(seed): both packages draw
    the public keys of init_phase1 and init_phase2 from it."""
    st = random.Random(seed)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(secrets, "randbelow", lambda n: st.randrange(n))
        yield


def ceremony(mod, builder, first=None, **kw):
    """A seeded ceremony at power 3 with the module `mod`: two phase-1 and
    two phase-2 contributions on tpusnark's cubic circuit, then the keys.
    `first` replaces the initial phase-1 transcript; `kw` goes to each
    contribute."""
    st = random.Random(0xCE5E)
    rng = lambda: st.randrange(1, R)  # noqa: E731
    if first is None:
        with seeded_secrets(7):
            first = mod.init_phase1(3)
    p1 = [first]
    for _ in range(2):
        nxt = copy.deepcopy(p1[-1])
        nxt.contribute(rng, **kw)
        p1.append(nxt)
    cs = cubic(builder)
    with seeded_secrets(8):
        p2_0, evals = mod.init_phase2(cs, p1[-1])
    p2 = [p2_0]
    for _ in range(2):
        nxt = copy.deepcopy(p2[-1])
        nxt.contribute(rng, **kw)
        p2.append(nxt)
    pk, vk = mod.extract_keys(cs, p1[-1], p2[-1], evals)
    return SimpleNamespace(p1=p1, p2=p2, evals=evals, cs=cs, pk=pk, vk=vk)


@pytest.fixture(scope="module")
def jax_run():
    return ceremony(jm, Builder)


@pytest.fixture(scope="module")
def host_run():
    """The port on its host branch (every list is under _DEVICE_THRESHOLD)."""
    return ceremony(tm, TBuilder, device="cpu")


@pytest.fixture(scope="module")
def device_run(jax_run):
    """The port with _DEVICE_THRESHOLD = 1: every rescale through VarBaseMul
    on CPU tensors (counted), from tpusnark's initial transcript read back by
    Phase1.from_bytes."""
    calls = []

    class Counted(VarBaseMul):
        def __call__(self, points_affine, scalars_norm):
            calls.append(scalars_norm.shape[-1])
            return super().__call__(points_affine, scalars_norm)

    first = tm.Phase1.from_bytes(jax_run.p1[0].to_bytes())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tm, "_DEVICE_THRESHOLD", 1)
        mp.setattr(tm, "VarBaseMul", Counted)
        run = ceremony(tm, TBuilder, first=first, device="cpu")
    run.calls = calls
    return run


# --------------------------------------------------------------- VarBaseMul
def scalars_and_points(host, group, seed):
    """Eight lanes: scalars 0, 1, r - 1 and seeded ones over seeded points,
    lane 3's point at infinity."""
    G = host.G1 if group == "g1" else host.G2
    rng = random.Random(seed)
    scalars = [0, 1, host.R - 1] + [rng.randrange(host.R) for _ in range(5)]
    points = [G.mul(G.generator(), rng.randrange(1, host.R)) for _ in scalars]
    points[3] = None
    return G, scalars, points


@pytest.mark.parametrize("group", ("g1", "g2"))
def test_var_base_mul_equals_tpusnark_and_the_host(group):
    """BN254: lane i is s_i * P_i, as tpusnark's VarBaseMul (JAX on the CPU)
    and the host module give it, for scalars 0, 1 and r - 1 and an infinity
    input."""
    cfg, jcfg = get_curve("bn254"), jget_curve("bn254")
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    G, scalars, points = scalars_and_points(cfg.host, group, 11)
    g1, g2 = curve_ops("bn254")
    jfp, jfr = jfield.get_field(jcfg.fp_spec), jfield.get_field(jcfg.fr_spec)
    jsc = jnp.asarray(jcfg.fr_spec.encode(scalars, mont=False).T.copy())
    if group == "g1":
        out = VarBaseMul(g1, fr)(tenc.g1_to_device(points, fp), fr.encode(scalars, mont=False))
        ours = tenc.g1_from_device_proj(out, fp)
        jmul = jbm.VarBaseMul(jcurve.g1_ops(jfp, b=jcfg.g1_b), jfr)
        theirs = jenc.g1_from_device_proj(jmul(jenc.g1_to_device(points, jfp), jsc), jfp)
    else:
        out = VarBaseMul(g2, fr)(tenc.g2_to_device(points, fp), fr.encode(scalars, mont=False))
        ours = tenc.g2_from_device_proj(out, fp, cfg.host.Fp2, cfg.fp2_q)
        jmul = jbm.VarBaseMul(jcurve.g2_ops(jfp, b3=jcfg.g2_b3), jfr)
        theirs = jenc.g2_from_device_proj(jmul(jenc.g2_to_device(points, jfp), jsc), jfp, fp2_cls=cfg.host.Fp2)
    want = [G.mul(pt, s) for pt, s in zip(points, scalars)]
    assert ours == theirs == want
    assert ours[0] is None and ours[3] is None and ours[1] == points[1] and ours[2] == G.neg(points[2])


def test_var_base_mul_on_bls12_381_g1_equals_the_host():
    """The class is generic over the curves: BLS12-381's G1 (9-word fr, R =
    2^288) against its host module."""
    cfg = get_curve("bls12-381")
    fp, fr = get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    G, scalars, points = scalars_and_points(cfg.host, "g1", 12)
    out = VarBaseMul(curve_ops("bls12-381")[0], fr)(tenc.g1_to_device(points, fp), fr.encode(scalars, mont=False))
    assert tenc.g1_from_device_proj(out, fp) == [G.mul(pt, s) for pt, s in zip(points, scalars)]


# ------------------------------------------------------- the seeded ceremony
def key_image(keys, fields):
    return [getattr(keys, f) for f in fields]


@pytest.mark.parametrize("branch", ("host_run", "device_run"))
def test_seeded_ceremony_equals_tpusnark_byte_for_byte(branch, jax_run, request):
    """Transcripts (to_bytes), hashes and extracted keys equal tpusnark's, on
    the host branch and with every rescale through VarBaseMul."""
    ours = request.getfixturevalue(branch)
    for a, b in zip(ours.p1, jax_run.p1):
        assert a.to_bytes() == b.to_bytes() and a.hash == b.hash == a.compute_hash()
    for a, b in zip(ours.p2, jax_run.p2):
        assert a.to_bytes() == b.to_bytes() and a.hash == b.hash == a._hash_body()
    assert dataclasses.asdict(ours.evals) == dataclasses.asdict(jax_run.evals)
    assert key_image(ours.pk, PK_FIELDS) == key_image(jax_run.pk, PK_FIELDS)
    assert key_image(ours.vk, VK_FIELDS) == key_image(jax_run.vk, VK_FIELDS)
    assert type(ours.pk) is tg16.ProvingKey and type(ours.vk) is tg16.VerifyingKey
    if branch == "device_run":  # 4 lists a phase-1 contribution, 2 (Z, L) a phase-2 one
        n = ours.p1[0].n
        assert ours.calls == [2 * n - 1, n, n, n] * 2 + [len(ours.p2[0].z_g1), len(ours.p2[0].l_g1)] * 2


def test_port_link_on_a_tpusnark_transcript_verifies_with_tpusnark(jax_run, device_run):
    """A port contribution (through VarBaseMul) to tpusnark's transcript,
    read by Phase1.from_bytes, passes tpusnark's verify_phase1, and the
    transcripts read back from bytes."""
    jm.verify_phase1(jax_run.p1[0], device_run.p1[1])
    back = tm.Phase2.from_bytes(device_run.p2[-1].to_bytes())
    assert back.l_g1 == device_run.p2[-1].l_g1 and back.z_g1 == device_run.p2[-1].z_g1


@pytest.fixture(scope="module")
def proof(device_run):
    """The port's prove (on the CPU) under the keys extract_keys made."""
    st = random.Random(3)
    return tg16.prove(device_run.cs, device_run.pk, ASSIGN, rng=lambda: st.randrange(R), device="cpu")


def test_prove_under_the_ceremony_keys_is_accepted_by_both_verifiers(device_run, proof):
    for verify in (tg16.verify, jverify.verify):
        assert verify(proof, device_run.vk, [35])
        assert not verify(proof, device_run.vk, [36])


def test_marshal_round_trips_equal_tpusnark_bytes(device_run, proof):
    """The ceremony's keys and the port's proof through the port's marshal:
    each stream (compressed and raw) equals tpusnark's marshal of the same
    objects, and reads back equal field for field."""
    pk, vk = device_run.pk, device_run.vk
    for raw in (False, True):
        data = tmarshal.proof_to_bytes(proof, raw=raw)
        assert data == jmarshal.proof_to_bytes(proof, raw=raw)
        assert tmarshal.proof_from_bytes(data) == proof
        data = tmarshal.vk_to_bytes(vk, raw=raw)
        assert data == jmarshal.vk_to_bytes(vk, raw=raw)
        assert tmarshal.vk_from_bytes(data) == vk
        data = tmarshal.pk_to_bytes(pk, raw=raw)
        assert data == jmarshal.pk_to_bytes(pk, raw=raw)
        back = tmarshal.pk_from_bytes(data)
        assert type(back) is tg16.ProvingKey
        fields = [f for f in PK_FIELDS if f != "k_wires"] + ["commitment_keys"]
        assert key_image(back, fields) == key_image(pk, fields)


def test_exported_contract_accepts_the_proof(device_run, proof):
    """export_solidity of the ceremony's vk equals tpusnark's; run on the
    port's proof by tpusnark's contract interpreter, it accepts the right
    public input and reverts on a wrong one."""
    src = tg16.export_solidity(device_run.vk)
    assert src == jsolidity.export_solidity(device_run.vk)
    words = tg16.proof_to_solidity_calldata(proof)
    assert words == jsolidity.proof_to_solidity_calldata(proof)
    Contract(src).call("verifyProof", words, [35])
    with pytest.raises(ContractRevert):
        Contract(src).call("verifyProof", words, [36])


def test_tampered_contribution_rejected():
    """tests/test_mpcsetup.py's tampered links, against the port; and a
    phase-2 link whose L lost a factor of delta^-1."""
    st = random.Random(0xBAD)
    rng = lambda: st.randrange(1, R)  # noqa: E731

    p1_init = tm.init_phase1(2)
    p1_a = copy.deepcopy(p1_init)
    p1_a.contribute(rng, device="cpu")

    # tamper: swap in a fresh PoK not derived from the previous hash
    p1_bad = copy.deepcopy(p1_a)
    p1_bad.pk_tau = tm.new_public_key(7, b"forged", 1, rng)
    with pytest.raises(ValueError):
        tm.verify_phase1(p1_init, p1_bad)

    # tamper: replace a parameter point (breaks geometric consistency)
    p1_bad2 = copy.deepcopy(p1_a)
    p1_bad2.tau_g1[2] = p1_bad2.tau_g1[1]
    p1_bad2.hash = p1_bad2.compute_hash()
    with pytest.raises(ValueError):
        tm.verify_phase1(p1_init, p1_bad2)

    p2_init, _ = tm.init_phase2(cubic(TBuilder), p1_a)
    p2_a = copy.deepcopy(p2_init)
    p2_a.contribute(rng, device="cpu")
    p2_bad = copy.deepcopy(p2_a)
    p2_bad.l_g1[0] = p2_init.l_g1[0]
    p2_bad.hash = p2_bad._hash_body()
    with pytest.raises(ValueError, match="invalid update of L"):
        tm.verify_phase2(p2_init, p2_bad)
