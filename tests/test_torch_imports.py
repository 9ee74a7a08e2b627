"""The port runs where JAX is not installed: every module of tpusnark_torch,
tpusnark's host modules it loads through ``_host``, and chip_smoke.py import
in a process where ``import jax`` fails. chip_smoke.py exits non-zero, with
no result line, where there is no CUDA device and where it stands alone."""

import os
import shutil
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

NO_JAX = textwrap.dedent(
    """
    import importlib, pkgutil, sys
    sys.modules["jax"] = None  # any import of jax now raises ImportError
    sys.path.insert(0, {root!r})
    import tpusnark_torch
    names = [m.name for m in pkgutil.walk_packages(tpusnark_torch.__path__, "tpusnark_torch.")]
    for name in names:
        importlib.import_module(name)
    from tpusnark_torch import _host
    from tpusnark_torch.backend.groth16 import prove, setup
    import chip_smoke
    assert _host.verify.verify and _host.setup.k_pk_wires_for
    assert "tpusnark_torch.backend.groth16.prove" in names
    assert sys.modules["jax"] is None
    print("imported", len(names))
    """
)

# The BLS12-381 path at a tiny size: its host modules load lazily
# (CurveConfig.host, bls381), so they are reached by running the path.
NO_JAX_BLS = textwrap.dedent(
    """
    import sys
    sys.modules["jax"] = None
    sys.path.insert(0, {root!r})
    from tpusnark.curves.config import get_curve
    from tpusnark_torch import _host
    from tpusnark_torch.curves.encoding import g1_to_device, g2_from_device_proj, g2_to_device
    from tpusnark_torch.curves.tcurve import curve_ops
    from tpusnark_torch.fields.tfield import get_field
    from tpusnark_torch.msm.pippenger import get_msm
    from tpusnark_torch.poly.ntt import get_ntt

    cfg = get_curve("bls12-381")
    host, fp, fr = cfg.host, get_field(cfg.fp_spec), get_field(cfg.fr_spec)
    g1, g2 = curve_ops("bls12-381")
    G = host.G2.generator()
    X, Y, inf = g2_to_device([G, G], fp)
    two = g2_from_device_proj(g2.add_mixed(g2.from_affine((X, Y, inf)), (X, Y, inf)), fp, host.Fp2, cfg.fp2_q)
    assert two == [host.G2.add(G, G)] * 2
    pts = [host.G1.generator(), None, host.G1.mul(host.G1.generator(), 3)]
    out = get_msm("g1", 4, "bls12-381")(g1_to_device(pts, fp), fr.encode([5, 7, 0], mont=False))
    assert out[0].shape[0] == 12
    ntt = get_ntt(cfg.fr_spec, 8)
    assert ntt.field.decode(ntt.intt(ntt.ntt(fr.encode(list(range(8)))))) == list(range(8))
    assert _host.bls381.verify and _host.verify.verify
    assert sys.modules["jax"] is None
    print("bls12-381 ok")
    """
)


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    res = _run([sys.executable, "-c", NO_JAX.format(root=ROOT)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("imported")


def test_bls12381_path_runs_without_jax():
    res = _run([sys.executable, "-c", NO_JAX_BLS.format(root=ROOT)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "bls12-381 ok"


def test_chip_smoke_fails_without_a_card():
    res = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
