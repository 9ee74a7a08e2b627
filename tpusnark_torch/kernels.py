"""Build, bind and launch the port's hand-written CUDA kernels (``csrc/``).

The sources are compiled with ``nvcc`` into one shared library with a plain C
interface, at first use, into ``csrc/_build/<hash of sources and flags>/``;
the library is bound with ``ctypes``. Nothing here is imported or built until
a CUDA tensor reaches a wrapper, so the module imports on a machine without
``nvcc`` or a card.

Every wrapper takes CUDA tensors only: int32 ``(8, N)`` limb-major words that
hold uint32 bit patterns, contiguous. It checks them, allocates its outputs
with ``torch.empty``, launches on the current stream, raises if the launch
failed, and adds one to ``LAUNCHES[name]``. The CPU counterparts (the plain
versions) live beside the callers in ``fields/tfield.py``,
``poly/ntt.py`` and ``curves/tcurve.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("field.cu", "ntt.cu", "curve.cu")
HEADERS = ("bn254.cuh",)
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-O3",
    "-std=c++17",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

# field spec name -> (id passed to the C entry points, tag in kernel names)
SPECS = {"bn254_fr": (0, "fr"), "bn254_fp": (1, "fp")}
FIELD_OPS = ("mul", "from_mont", "add", "sub", "neg")

# one counter per kernel instance; a wrapper adds one per launch
LAUNCHES: dict[str, int] = dict.fromkeys(
    [f"{op}[{tag}]" for op in FIELD_OPS for _, tag in SPECS.values()]
    + ["butterfly", "butterfly4", "g1_add", "g1_add_mixed", "g2_add", "g2_add_mixed"],
    0,
)

BUILD_INFO: dict = {}

_lib = None

_P = ctypes.c_void_p
_SIGNATURES = {
    "ts_field_mul": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_field_add": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_field_sub": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_field_from_mont": (ctypes.c_int, _P, _P, ctypes.c_long, _P),
    "ts_field_neg": (ctypes.c_int, _P, _P, ctypes.c_long, _P),
    "ts_ntt_butterfly": (_P, _P, _P, _P, _P, ctypes.c_long, _P),
    "ts_ntt_butterfly4": (_P, ctypes.c_long, _P),
    "ts_curve_add": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_curve_add_mixed": (ctypes.c_int, _P, _P, _P, _P, ctypes.c_long, _P),
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in sorted(SOURCES + HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = CSRC / "_build" / _source_hash()
    so = out_dir / "libtpusnark_torch_kernels.so"
    t0 = time.perf_counter()
    compiled = False
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(CSRC / s) for s in SOURCES)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
        os.replace(tmp, so)
        compiled = True
    lib = ctypes.CDLL(str(so))
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(sig)
        fn.restype = ctypes.c_int
    BUILD_INFO.update(
        path=str(so), compiled=compiled, seconds=time.perf_counter() - t0
    )
    _lib = lib
    return lib


# ------------------------------------------------------------------ checks
def _check(t: torch.Tensor, n: int | None = None, what: str = "operand") -> int:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != 8:
        raise ValueError(f"{what}: expected shape (8, N), got {tuple(t.shape)}")
    if n is not None and t.shape[1] != n:
        raise ValueError(f"{what}: expected {n} lanes, got {t.shape[1]}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    return t.shape[1]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(name: str, fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error {rc}")
    LAUNCHES[name] += 1


def _ptr_array(tensors) -> ctypes.Array:
    return (ctypes.c_uint64 * len(tensors))(*(t.data_ptr() for t in tensors))


# ------------------------------------------------------------------ field
def _spec(spec) -> tuple[int, str]:
    try:
        return SPECS[spec.name]
    except KeyError:
        raise ValueError(f"no CUDA kernels for field {spec.name}") from None


def field_binary(op: str, spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op in {mul, add, sub}: B1 (mul) and the lazy add/sub, lanewise."""
    n = _check(a, what=f"{op} a")
    _check(b, n, what=f"{op} b")
    sid, tag = _spec(spec)
    lib = build()
    out = torch.empty_like(a)
    if n:
        fn = getattr(lib, f"ts_field_{op}")
        _launch(f"{op}[{tag}]", fn, sid, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _stream(a))
    return out


def field_unary(op: str, spec, a: torch.Tensor) -> torch.Tensor:
    """op in {from_mont, neg}: B2 (from_mont) and the lazy negation."""
    n = _check(a, what=f"{op} a")
    sid, tag = _spec(spec)
    lib = build()
    out = torch.empty_like(a)
    if n:
        fn = getattr(lib, f"ts_field_{op}")
        _launch(f"{op}[{tag}]", fn, sid, a.data_ptr(), out.data_ptr(), n, _stream(a))
    return out


# ------------------------------------------------------------------ NTT
def butterfly(e, o, w):
    """B3: (e + o*w, e - o*w) over fr."""
    n = _check(e, what="butterfly e")
    _check(o, n, "butterfly o")
    _check(w, n, "butterfly w")
    lib = build()
    a, b = torch.empty_like(e), torch.empty_like(e)
    if n:
        _launch(
            "butterfly",
            lib.ts_ntt_butterfly,
            e.data_ptr(),
            o.data_ptr(),
            w.data_ptr(),
            a.data_ptr(),
            b.data_ptr(),
            n,
            _stream(e),
        )
    return a, b


def butterfly4(x0, x1, x2, x3, w1, w2a, w2b):
    """B4: two DIT stages; returns (y0+u2, y1+u3, y0-u2, y1-u3)."""
    ins = (x0, x1, x2, x3, w1, w2a, w2b)
    n = _check(x0, what="butterfly4 x0")
    for i, t in enumerate(ins):
        _check(t, n, f"butterfly4 operand {i}")
    lib = build()
    outs = tuple(torch.empty_like(x0) for _ in range(4))
    if n:
        ptrs = _ptr_array(ins + outs)
        _launch("butterfly4", lib.ts_ntt_butterfly4, ctypes.addressof(ptrs), n, _stream(x0))
    return outs


# ------------------------------------------------------------------ curves
def curve_op(op: str, g2: bool, ins, inf=None, b3_words=None):
    """B5 (op = add_mixed) and B6 (op = add) over G1 (g2 = False) or G2.

    ins: the coordinate components of both operands, flattened in order
    (G1: X1 Y1 Z1 X2 Y2 [Z2]; G2: X1.c0 X1.c1 Y1.c0 ...), each (8, N).
    inf: (N,) bool for add_mixed, lanes that return the first operand.
    b3_words: G2 only, 16 uint32 words of 3b' (c0 then c1, Montgomery).
    Returns the output components (X, Y, Z; G2: X.c0, X.c1, ...)."""
    deg = 2 if g2 else 1
    want = deg * (6 if op == "add" else 5)
    if len(ins) != want:
        raise ValueError(f"{op}: expected {want} coordinate components, got {len(ins)}")
    n = _check(ins[0], what=f"{op} X1")
    for i, t in enumerate(ins):
        _check(t, n, f"{op} component {i}")
    if inf is not None:
        if op != "add_mixed":
            raise ValueError("only add_mixed takes an infinity mask")
        if inf.device != ins[0].device or inf.dtype != torch.bool or inf.shape != (n,):
            raise ValueError("inf: expected a (N,) bool tensor on the same card")
        if not inf.is_contiguous():
            raise ValueError("inf: expected a contiguous tensor")
    lib = build()
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3 * deg))
    if g2:
        if b3_words is None or len(b3_words) != 16:
            raise ValueError("G2 needs the 16 words of 3b'")
        b3 = (ctypes.c_uint32 * 16)(*b3_words)
        b3_ptr = ctypes.addressof(b3)
    else:
        b3_ptr = None
    if n:
        name = f"{'g2' if g2 else 'g1'}_{op}"
        in_ptrs, out_ptrs = _ptr_array(ins), _ptr_array(outs)
        if op == "add":
            _launch(
                name,
                lib.ts_curve_add,
                int(g2),
                ctypes.addressof(in_ptrs),
                ctypes.addressof(out_ptrs),
                b3_ptr,
                n,
                _stream(ins[0]),
            )
        else:
            _launch(
                name,
                lib.ts_curve_add_mixed,
                int(g2),
                ctypes.addressof(in_ptrs),
                ctypes.addressof(out_ptrs),
                None if inf is None else inf.data_ptr(),
                b3_ptr,
                n,
                _stream(ins[0]),
            )
    return outs
