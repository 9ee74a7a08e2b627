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


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_port_imports_without_jax():
    res = _run([sys.executable, "-c", NO_JAX.format(root=ROOT)], ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("imported")


def test_chip_smoke_fails_without_a_card():
    res = _run([sys.executable, "chip_smoke.py"], ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    res = _run([sys.executable, "chip_smoke.py"], str(tmp_path))
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
