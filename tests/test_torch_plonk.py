"""The port's PLONK over BN254 (tpusnark_torch.backend.plonk, on the CPU)
against tpusnark's on the cubic circuit of tests/test_plonk.py (x^3 + x + 5
== y, tau 123456789, blinding rng random.Random(42)): the port's setup,
prove and verifier run in a process where jax and tpusnark cannot be
imported (test_torch_imports.start_plonk_without_jax), tpusnark's here. The
verifying keys and the proofs are equal field for field; the port's
verifier accepts the proof and rejects a wrong public input, a tampered
claimed value and a tampered commitment; tpusnark's verifier accepts the
port's proof; the wires, z and quotient stages give tpusnark's outputs on
the same inputs. Exact: device outputs are compared as ints mod p.

tpusnark's setup and prove take ~2 minutes here, most of it JAX compiling
the prover's stages; this file makes one of each, in a module fixture."""

import dataclasses
import inspect
import random
from importlib import import_module

import jax.numpy as jnp
import pytest
import torch

from tpusnark.backend import plonk as jplonk
from tpusnark.fields.jfield import get_field as jget_field
from tpusnark.fields.spec import BN254_FR as JBN254_FR
from tpusnark.frontend.plonk_builder import PlonkBuilder as JPlonkBuilder
from tpusnark.poly.ntt import get_ntt as jget_ntt
from tpusnark_torch.backend import plonk as tplonk
from tpusnark_torch.curves.ref import G1
from tpusnark_torch.fields.spec import BN254_FR
from tpusnark_torch.fields.tfield import get_field
from tpusnark_torch.frontend.plonk_builder import PlonkBuilder
from tpusnark_torch.poly import kzg as tkzg
from tpusnark_torch.poly.ntt import get_ntt

from tests.test_torch_imports import start_plonk_without_jax

torch.set_num_threads(1)  # the suite's workers fill the cores already

# the plonk packages export the function prove, which hides the submodule of
# that name from "import ... as"
jprove, tprove = (import_module(f"{pkg}.backend.plonk.prove") for pkg in ("tpusnark", "tpusnark_torch"))

P = BN254_FR.modulus
TAU = 123456789
ASSIGN = {"x": 3, "y": 35}
fr, jfr = get_field(BN254_FR), jget_field(JBN254_FR)


def cubic(Builder, P):
    """x**3 + x + 5 == y (the gnark hello-world, tests/test_plonk.py)."""
    b = Builder(P)
    x = b.secret("x")
    y = b.public("y")
    b.assert_is_equal(b.add(b.mul(x, x, x), x, 5), y)
    return b.compile()


def _rng_seq(seed):
    r = random.Random(seed)
    return lambda: r.randrange(1, P)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(port's pk, vk, proof, phase names; tpusnark's cs, pk, vk, proof)."""
    wait = start_plonk_without_jax(cubic, ASSIGN, [35], TAU, 42, tmp_path_factory.mktemp("plonk"))
    jcs = cubic(JPlonkBuilder, P)
    jpk, jvk = jplonk.setup(jcs, tau=TAU)
    jproof = jplonk.prove(jcs, jpk, ASSIGN, rng=_rng_seq(42))
    return (*wait(), jcs, jpk, jvk, jproof)


def test_verifying_key_equals_tpusnark(artifacts):
    pk, vk, _, _, _, jpk, jvk, _ = artifacts
    assert dataclasses.asdict(vk) == dataclasses.asdict(jvk)
    assert (pk.domain_n, pk.slice_shift, pk.slice_xn) == (jpk.domain_n, jpk.slice_shift, jpk.slice_xn)
    assert fr.decode(pk.s_lag) == [v for k in ("s1", "s2", "s3") for v in jpk.s_evals_int[k]]
    for name in ("ql", "qr", "qm", "qo", "qc"):
        assert fr.decode(pk.q_coeffs[name]) == jfr.to_ints(jpk.q_coeffs[name]), name
    for name in ("s1", "s2", "s3"):
        assert fr.decode(pk.s_coeffs[name]) == jfr.to_ints(jpk.s_coeffs[name]), name
    for r in range(4):
        assert fr.decode(pk.coset_scale[r]) == jfr.to_ints(jpk.coset_scale[r]), r
    assert fr.decode(pk.omega_pows) == jfr.to_ints(jpk.omega_pows)
    assert pk.srs.g1 == jpk.srs.g1 and pk.srs.g2 == jpk.srs.g2


def test_device_tables_equal_tpusnark(artifacts):
    pk, _, _, _, _, jpk, _, _ = artifacts
    tab, jtab = pk.dev(), jpk.dev()
    assert tab["maxm"] == jtab["maxm"]
    for name in ("ids", "s_lag", "wpow", "lin_base", "s12"):
        assert fr.decode(tab[name]) == jfr.to_ints(jtab[name]), name
    assert tab["qcp_stack"] is None and jtab["qcp_stack"] is None


def test_proof_equals_tpusnark_field_for_field(artifacts):
    _, _, proof, phases, _, _, _, jproof = artifacts
    assert len(proof.claimed_values) == 7 and proof.bsb22_commitments == []
    for f in dataclasses.fields(jproof):
        assert getattr(proof, f.name) == getattr(jproof, f.name), f.name
    assert phases == sorted(("solve", "lro", "z", "quotient", "open"))


def test_port_verifier_accepts_and_rejects(artifacts):
    _, vk, proof, _, _, _, _, _ = artifacts
    assert tplonk.verify(proof, vk, [35])
    assert not tplonk.verify(proof, vk, [36])
    cv = list(proof.claimed_values)
    cv[2] = (cv[2] + 1) % P  # the claimed l(zeta)
    assert not tplonk.verify(dataclasses.replace(proof, claimed_values=cv), vk, [35])
    assert not tplonk.verify(dataclasses.replace(proof, z_com=vk.ql), vk, [35])
    bad_h = G1.add(proof.batched_h, G1.generator())
    assert not tplonk.verify(dataclasses.replace(proof, batched_h=bad_h), vk, [35])


def test_tpusnark_verifier_accepts_the_port_proof(artifacts):
    _, _, proof, _, _, _, jvk, _ = artifacts
    assert jplonk.verify(proof, jvk, [35])
    assert not jplonk.verify(proof, jvk, [36])


def ints(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(P) for _ in range(n)]


def both(xs, *shape):
    """The same ints as the port's (words, *shape) and tpusnark's (limbs,
    *shape) Montgomery arrays."""
    return fr.encode(xs).view(fr.n, *shape), jfr.array(xs).reshape((jfr.n,) + shape)


def same(t, j, mont=True):
    return fr.decode(t, mont=mont) == [v % P for v in jfr.to_ints(j, mont=mont)]


def test_stages_equal_tpusnark(artifacts):
    """wires, z and quotient on the same inputs (tpusnark's stages are the
    jitted programs its prove compiled)."""
    pk, _, _, _, _, jpk, _, _ = artifacts
    n = pk.domain_n
    ntt_n, ntt_4n = get_ntt(BN254_FR, n, "cpu"), get_ntt(BN254_FR, 4 * n, "cpu")
    jntt_n, jntt_4n = jget_ntt(JBN254_FR, n), jget_ntt(JBN254_FR, 4 * n)
    lro, jlro = both(ints(3 * n, 1), 3, n)
    bl, jbl = both(ints(6, 2), 3, 2)
    hats, hats_norm = tprove.wires_stage(ntt_n, lro, bl)
    jhats, jhats_norm = jprove._wires_stage(n)(jlro, jbl, jntt_n._inv_tables())
    assert same(hats, jhats) and same(hats_norm, jhats_norm, mont=False)

    gamma, beta, alpha = ints(3, 3)
    zbl, jzbl = both(ints(3, 4), 3)
    tab, jtab = pk.dev(), jpk.dev()
    z_hat, z_norm = tprove.z_stage(
        ntt_n, lro, tab["ids"], tab["s_lag"], tkzg.scalar(gamma, "cpu"), tkzg.scalar(beta, "cpu"), zbl
    )
    jz_hat, jz_norm = jprove._z_stage(n)(
        jlro, jtab["ids"], jtab["s_lag"], jfr.const(gamma, mont=True), jfr.const(beta, mont=True), jzbl,
        jntt_n._inv_tables(),
    )
    assert same(z_hat, jz_hat) and same(z_norm, jz_norm, mont=False)

    # the quotient on the same ints: the hats and z as the port made them
    cols = {"l": hats[:, 0], "r": hats[:, 1], "o": hats[:, 2], "z": z_hat}
    cols["zw"] = fr.mul(z_hat, tab["wpow"])
    cols["pi"] = fr.encode(ints(n, 5))
    polys, jpolys = {}, {}
    for k, v in cols.items():
        polys[k], jpolys[k] = both(fr.decode(v), v.shape[1])
    h, h_norm = tprove.quotient_stage(ntt_n, ntt_4n, pk, polys, [], tprove.quotient_consts(pk, gamma, beta, alpha))
    per_slice = {
        "xn": [jfr.const(xn, mont=True) for xn in jpk.slice_xn],
        "zh_inv": [jfr.const(pow((xn - 1) % P, -1, P), mont=True) for xn in jpk.slice_xn],
        "s_r": [jfr.const(s, mont=True) for s in jpk.slice_shift],
        "s_r_k1": [jfr.const(s * jpk.vk.k1 % P, mont=True) for s in jpk.slice_shift],
        "s_r_k2": [jfr.const(s * jpk.vk.k2 % P, mont=True) for s in jpk.slice_shift],
    }
    Cs = {k: jnp.stack(v, axis=0) for k, v in per_slice.items()}
    Csh = {
        "gamma": jfr.const(gamma, mont=True),
        "beta": jfr.const(beta, mont=True),
        "a1": jfr.const(alpha, mont=True),
        "a2": jfr.const(alpha * alpha % P, mont=True),
        "n_inv": jfr.const(pow(n, -1, P), mont=True),
    }
    jh, jh_norm = jprove._quotient_stage(n, 0)(
        jpolys,
        jpk.q_coeffs,
        jpk.s_coeffs,
        (),
        (),
        jnp.stack(jpk.coset_scale, axis=0),
        jpk.omega_pows,
        jntt_n._fwd_tables(),
        Cs,
        Csh,
        jntt_4n._inv_tables(),
        jntt_4n._coset_tables()[1],
    )
    assert same(h, jh) and same(h_norm, jh_norm, mont=False)


def test_plonk_entry_points_run_on_the_card_unless_the_caller_names_the_cpu():
    """setup, new_srs_unsafe (its fixed-base path), SRS.device, commit_ints,
    open_ints and Polynomial.from_ints default to the card; with no card
    they raise and do not fall back to the CPU. prove runs where its key
    lies."""
    from tpusnark_torch.poly.iop import Polynomial

    for fn in (tplonk.setup, tkzg.new_srs_unsafe, tkzg.SRS.device, tkzg.commit_ints, tkzg.open_ints):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    assert inspect.signature(Polynomial.from_ints).parameters["device"].default == "cuda"
    assert "device" not in inspect.signature(tplonk.prove).parameters
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default runs there")
    cs = cubic(PlonkBuilder, P)
    srs = tkzg.new_srs_unsafe(11, tau=TAU)  # below 2^10 the points are host work
    for make in (
        lambda: tplonk.setup(cs, tau=TAU),
        lambda: tplonk.setup(cs, srs=srs),
        lambda: tkzg.new_srs_unsafe(tkzg.DEVICE_SRS_MIN, tau=TAU),
        lambda: srs.device(),
        lambda: tkzg.commit_ints(srs, [1] * 256),
        lambda: Polynomial.from_ints([1, 2], BN254_FR),
    ):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            make()
