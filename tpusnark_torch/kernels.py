"""Build, bind and launch the port's hand-written CUDA kernels (``csrc/``).

Each source is compiled with ``nvcc`` into an object, all sources at once in
parallel processes, and the objects are linked into one shared library with
a plain C interface, at first use, into ``csrc/_build/<hash of sources and
flags>/``; the library is bound with ``ctypes``. ``ptxas`` reports each
kernel's registers and spills (``-Xptxas -v``); the report is kept in
``BUILD_INFO["ptxas"]`` and in ``ptxas.log`` beside the library. Nothing
here is imported or built until a CUDA tensor reaches a wrapper, so the
module imports on a machine without ``nvcc`` or a card.

Every wrapper takes CUDA tensors only: int32 ``(words, N)`` limb-major words
that hold uint32 bit patterns, contiguous, with the word count of the field
(8 for BN254 and BLS12-377 fr, 9 for BLS12-381 fr, 12 for BLS12-381 fp,
BLS12-377 fp and BW6-761 fr, 24 for BW6-761 fp). It checks them, and
refuses a field or curve without kernels before anything is built; it
allocates its outputs with ``torch.empty``, launches on the current stream,
raises if the launch failed, and adds one to ``LAUNCHES[name]``. Instance
names carry the field (``mul[bls12_381_fp]``) or the curve
(``g2_add_mixed[bls12-381]``). The CPU counterparts (the plain versions)
live beside the callers in ``fields/tfield.py``, ``poly/ntt.py`` and
``curves/tcurve.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (
    "field.cu",
    "ntt.cu",
    "curve_bn254.cu",
    "curve_bls12_381.cu",
    "curve_bls12_377.cu",
    "curve_bw6_761.cu",
)
HEADERS = ("mont.cuh", "curve.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# field spec name -> (id of the field in csrc/mont.cuh, words)
SPECS = {
    "bn254_fr": (0, 8),
    "bn254_fp": (1, 8),
    "bls12_381_fr": (2, 9),
    "bls12_381_fp": (3, 12),
    "bls12_377_fr": (4, 8),
    "bls12_377_fp": (5, 12),
    "bw6_761_fr": (6, 12),
    "bw6_761_fp": (7, 24),
}
# curve name -> (scalar field, base field); its curve kernels are
# ts_curve_<tag>, tag = the base field's name without "_fp"
CURVES = {
    "bn254": ("bn254_fr", "bn254_fp"),
    "bls12-381": ("bls12_381_fr", "bls12_381_fp"),
    "bls12-377": ("bls12_377_fr", "bls12_377_fp"),
    "bw6-761": ("bw6_761_fr", "bw6_761_fp"),
}
# curves whose G2 lies over Fp itself: its kernels are the Fp instances,
# launched and counted under the g2_* names
G2_OVER_FP = frozenset({"bw6-761"})
FIELD_OPS = ("mul", "from_mont", "add", "sub")
BASE_FIELD_OPS = FIELD_OPS + ("neg",)  # no path negates a scalar
CURVE_OPS = ("g1_add", "g1_add_mixed", "g2_add", "g2_add_mixed")


def base_field_ops(curve: str) -> tuple[str, ...]:
    """The ops with a kernel over `curve`'s base field. Outside the curve
    kernels only an Fp2 inversion adds and subtracts base-field elements, so
    a curve whose G2 lies over Fp has no add and no sub instance."""
    return ("mul", "from_mont", "neg") if curve in G2_OVER_FP else BASE_FIELD_OPS


# base field spec name -> its ops
BASE_FIELDS = {fp: base_field_ops(curve) for curve, (_, fp) in CURVES.items()}


def instances(curve: str) -> list[str]:
    """The kernel instances of one curve's path, by launch-counter name."""
    fr, fp = CURVES[curve]
    return (
        [f"{op}[{fr}]" for op in FIELD_OPS]
        + [f"{op}[{fp}]" for op in BASE_FIELDS[fp]]
        + [f"butterfly[{fr}]", f"butterfly4[{fr}]"]
        + [f"{op}[{curve}]" for op in CURVE_OPS]
    )


def _tag(fp: str) -> str:
    return fp.removesuffix("_fp")


# one counter per kernel instance; a wrapper adds one per launch
LAUNCHES: dict[str, int] = dict.fromkeys([k for c in CURVES for k in instances(c)], 0)

BUILD_INFO: dict = {}

_lib = None

_P = ctypes.c_void_p
_SIGNATURES = {
    "ts_field_mul": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_field_add": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_field_sub": (ctypes.c_int, _P, _P, _P, ctypes.c_long, _P),
    "ts_field_from_mont": (ctypes.c_int, _P, _P, ctypes.c_long, _P),
    "ts_field_neg": (ctypes.c_int, _P, _P, ctypes.c_long, _P),
    "ts_ntt_butterfly": (ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_long, _P),
    "ts_ntt_butterfly4": (ctypes.c_int, _P, ctypes.c_long, _P),
    **{
        f"ts_curve_{_tag(fp)}": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_long, _P)
        for _, fp in CURVES.values()
    },
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


def _compile(out_dir: Path, so: Path) -> dict:
    """One nvcc per source, all started together, then one link; the ptxas
    reports go to ptxas.log. Returns the compile seconds per source."""
    nvcc = _nvcc()
    objs = {src: out_dir / (Path(src).stem + ".o") for src in SOURCES}

    def compile_one(src):
        t0 = time.perf_counter()
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(objs[src]), str(CSRC / src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        return res, time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(SOURCES)) as pool:
        done = dict(zip(SOURCES, pool.map(compile_one, SOURCES)))
    reports = {src: res.stdout + res.stderr for src, (res, _) in done.items()}
    seconds = {src: sec for src, (_, sec) in done.items()}
    failed = [f"{src} ({res.returncode}):\n{res.stderr}" for src, (res, _) in done.items() if res.returncode]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [nvcc, *ARCH, "-shared", "-o", tmp, *(str(obj) for obj in objs.values())]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, so)
    (out_dir / "ptxas.log").write_text("".join(f"== {s}\n{r}" for s, r in reports.items()))
    return seconds


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    out_dir = CSRC / "_build" / _source_hash()
    so = out_dir / "libtpusnark_torch_kernels.so"
    t0 = time.perf_counter()
    compiled, source_seconds = False, {}
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        source_seconds = _compile(out_dir, so)
        compiled = True
    log = out_dir / "ptxas.log"
    lib = ctypes.CDLL(str(so))
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(sig)
        fn.restype = ctypes.c_int
    BUILD_INFO.update(
        path=str(so),
        compiled=compiled,
        seconds=time.perf_counter() - t0,
        source_seconds=source_seconds,
        ptxas=log.read_text() if log.exists() else "",
    )
    _lib = lib
    return lib


# ------------------------------------------------------------------ checks
def _check(t: torch.Tensor, words: int, n: int | None = None, what: str = "operand") -> int:
    if not isinstance(t, torch.Tensor) or t.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != words:
        raise ValueError(f"{what}: expected shape ({words}, N), got {tuple(t.shape)}")
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
def _spec(spec, op: str | None = None) -> tuple[int, int]:
    """(field id, words) of a spec with kernels; raises before any build."""
    try:
        fid, words = SPECS[spec.name]
    except KeyError:
        raise ValueError(f"no CUDA kernels for field {spec.name}") from None
    if op is not None and op not in BASE_FIELDS.get(spec.name, FIELD_OPS):
        raise ValueError(f"no CUDA kernel {op} for field {spec.name}")
    return fid, words


def field_binary(op: str, spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op in {mul, add, sub}: B1 (mul) and the lazy add/sub, lanewise."""
    fid, words = _spec(spec, op)
    n = _check(a, words, what=f"{op} a")
    _check(b, words, n, what=f"{op} b")
    lib = build()
    out = torch.empty_like(a)
    if n:
        fn = getattr(lib, f"ts_field_{op}")
        _launch(f"{op}[{spec.name}]", fn, fid, a.data_ptr(), b.data_ptr(), out.data_ptr(), n, _stream(a))
    return out


def field_unary(op: str, spec, a: torch.Tensor) -> torch.Tensor:
    """op in {from_mont, neg}: B2 (from_mont) and the lazy negation."""
    fid, words = _spec(spec, op)
    n = _check(a, words, what=f"{op} a")
    lib = build()
    out = torch.empty_like(a)
    if n:
        fn = getattr(lib, f"ts_field_{op}")
        _launch(f"{op}[{spec.name}]", fn, fid, a.data_ptr(), out.data_ptr(), n, _stream(a))
    return out


# ------------------------------------------------------------------ NTT
def _scalar_spec(spec) -> tuple[int, int]:
    fid, words = _spec(spec)
    if spec.name in BASE_FIELDS:
        raise ValueError(f"no NTT kernels for base field {spec.name}")
    return fid, words


def butterfly(spec, e, o, w):
    """B3: (e + o*w, e - o*w) over the scalar field `spec`."""
    fid, words = _scalar_spec(spec)
    n = _check(e, words, what="butterfly e")
    _check(o, words, n, "butterfly o")
    _check(w, words, n, "butterfly w")
    lib = build()
    a, b = torch.empty_like(e), torch.empty_like(e)
    if n:
        _launch(
            f"butterfly[{spec.name}]",
            lib.ts_ntt_butterfly,
            fid,
            e.data_ptr(),
            o.data_ptr(),
            w.data_ptr(),
            a.data_ptr(),
            b.data_ptr(),
            n,
            _stream(e),
        )
    return a, b


def butterfly4(spec, x0, x1, x2, x3, w1, w2a, w2b):
    """B4: two DIT stages; returns (y0+u2, y1+u3, y0-u2, y1-u3)."""
    fid, words = _scalar_spec(spec)
    ins = (x0, x1, x2, x3, w1, w2a, w2b)
    n = _check(x0, words, what="butterfly4 x0")
    for i, t in enumerate(ins):
        _check(t, words, n, f"butterfly4 operand {i}")
    lib = build()
    outs = tuple(torch.empty_like(x0) for _ in range(4))
    if n:
        ptrs = _ptr_array(ins + outs)
        _launch(
            f"butterfly4[{spec.name}]", lib.ts_ntt_butterfly4, fid, ctypes.addressof(ptrs), n, _stream(x0)
        )
    return outs


# ------------------------------------------------------------------ curves
def curve_of(fp_spec) -> str | None:
    """The curve whose kernels run over base field `fp_spec`, if any."""
    return next((c for c, (_, fp) in CURVES.items() if fp == fp_spec.name), None)


def curve_op(op: str, g2: bool, fp_spec, ins, b3_words, inf=None):
    """B5 (op = add_mixed) and B6 (op = add) over G1 (g2 = False) or G2 of
    the curve whose base field is `fp_spec`.

    ins: the coordinate components of both operands, flattened in order
    (over Fp: X1 Y1 Z1 X2 Y2 [Z2]; over Fp2: X1.c0 X1.c1 Y1.c0 ...), each
    (words, N). b3_words: the uint32 words of 3b (over Fp, words) or 3b'
    (over Fp2, c0 then c1, 2 * words) in Montgomery form. inf: (N,) bool for
    add_mixed, lanes that return the first operand. Returns the output
    components (X, Y, Z; over Fp2: X.c0, X.c1, ...). G2 is over Fp2, except
    for the curves in G2_OVER_FP."""
    curve = curve_of(fp_spec)
    if curve is None:
        raise ValueError(f"no CUDA curve kernels over {fp_spec.name}")
    words = SPECS[fp_spec.name][1]
    deg = 2 if g2 and curve not in G2_OVER_FP else 1
    want = deg * (6 if op == "add" else 5)
    if op not in ("add", "add_mixed"):
        raise ValueError(f"unknown curve op {op}")
    if len(ins) != want:
        raise ValueError(f"{op}: expected {want} coordinate components, got {len(ins)}")
    if len(b3_words) != deg * words:
        raise ValueError(f"{op}: expected {deg * words} words of 3b, got {len(b3_words)}")
    n = _check(ins[0], words, what=f"{op} X1")
    for i, t in enumerate(ins):
        _check(t, words, n, f"{op} component {i}")
    if inf is not None:
        if op != "add_mixed":
            raise ValueError("only add_mixed takes an infinity mask")
        if inf.device != ins[0].device or inf.dtype != torch.bool or inf.shape != (n,):
            raise ValueError("inf: expected a (N,) bool tensor on the same card")
        if not inf.is_contiguous():
            raise ValueError("inf: expected a contiguous tensor")
    lib = build()
    outs = tuple(torch.empty_like(ins[0]) for _ in range(3 * deg))
    if n:
        b3 = (ctypes.c_uint32 * len(b3_words))(*b3_words)
        in_ptrs, out_ptrs = _ptr_array(ins), _ptr_array(outs)
        _launch(
            f"{'g2' if g2 else 'g1'}_{op}[{curve}]",
            getattr(lib, f"ts_curve_{_tag(fp_spec.name)}"),
            0 if op == "add" else 1,
            int(g2),
            ctypes.addressof(in_ptrs),
            ctypes.addressof(out_ptrs),
            None if inf is None else inf.data_ptr(),
            ctypes.addressof(b3),
            n,
            _stream(ins[0]),
        )
    return outs
