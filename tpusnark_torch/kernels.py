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
that hold uint32 bit patterns, contiguous (the field ops also take rows of
any stride, and an operand expanded from one element), with the word count of the field
(8 for BN254, BLS12-377 and BLS24-315 fr, 9 for BLS12-381 and BLS24-317 fr,
10 for BLS24-315 fp, BLS24-317 fp and BW6-633 fr, 12 for BLS12-381 fp,
BLS12-377 fp and BW6-761 fr, 20 for BW6-633 fp, 24 for BW6-761 fp). It checks them, and
refuses a field or curve without kernels before anything is built; it
allocates its outputs with ``torch.empty`` (the NTT pass may write into its
input instead), launches on the current stream of its operands' card with
that card current (the operands may lie on any card, all on the same one),
raises if the launch failed, and adds one to ``LAUNCHES[name]``. Instance
names carry the field (``mul[bls12_381_fp]``) or the curve
(``g2_add_mixed[bls12-381]``, ``g1_strip_mixed[bn254]``). The CPU
counterparts (the plain versions) live beside the callers in
``fields/tfield.py``, ``poly/ntt.py``, ``curves/tcurve.py`` and
``msm/pippenger.py``.
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
    "curve_bw6_633.cu",
    "curve_bls24_315.cu",
    "curve_bls24_317.cu",
    "msm_bn254_g1.cu",
    "msm_bn254_g2.cu",
    "msm_bls12_381_g1.cu",
    "msm_bls12_381_g2.cu",
    "msm_bls12_377_g1.cu",
    "msm_bls12_377_g2.cu",
    "msm_bw6_761.cu",
    "msm_bw6_633.cu",
    "msm_bls24_315_g1.cu",
    "msm_bls24_315_g2.cu",
    "msm_bls24_317_g1.cu",
    "msm_bls24_317_g2.cu",
)
HEADERS = ("mont.cuh", "curve.cuh", "msm.cuh")
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
    "bls24_315_fr": (8, 8),
    "bls24_315_fp": (9, 10),
    "bls24_317_fr": (10, 9),
    "bls24_317_fp": (11, 10),
    "bw6_633_fr": (12, 10),
    "bw6_633_fp": (13, 20),
}
# curve name -> (scalar field, base field); its curve kernels are
# ts_curve_<tag>, tag = the base field's name without "_fp"
CURVES = {
    "bn254": ("bn254_fr", "bn254_fp"),
    "bls12-381": ("bls12_381_fr", "bls12_381_fp"),
    "bls12-377": ("bls12_377_fr", "bls12_377_fp"),
    "bw6-761": ("bw6_761_fr", "bw6_761_fp"),
    "bw6-633": ("bw6_633_fr", "bw6_633_fp"),
    "bls24-315": ("bls24_315_fr", "bls24_315_fp"),
    "bls24-317": ("bls24_317_fr", "bls24_317_fp"),
}
# curves whose G2 lies over Fp itself: its kernels are the Fp instances,
# launched and counted under the g2_* names
G2_OVER_FP = frozenset({"bw6-761", "bw6-633"})
# curves whose G2 lies over Fp4 = Fp2[v]/(v^2 - Z2): four components a
# coordinate
G2_OVER_FP4 = frozenset({"bls24-315", "bls24-317"})
FIELD_OPS = ("mul", "from_mont", "add", "sub")
BASE_FIELD_OPS = FIELD_OPS + ("neg",)  # no path negates a scalar
CURVE_OPS = ("g1_add", "g1_add_mixed", "g2_add", "g2_add_mixed")
# the MSM's fused kernels (csrc/msm.cuh) -> the `kernel` argument of ts_msm_*
MSM_KERNELS = {"strip_mixed": 0, "strip": 1, "scan_step": 2, "horner": 3}
MSM_OPS = tuple(f"{g}_{op}" for g in ("g1", "g2") for op in MSM_KERNELS)


def base_field_ops(curve: str) -> tuple[str, ...]:
    """The ops with a kernel over `curve`'s base field. Outside the curve
    kernels only an Fp2 inversion (also inside an Fp4 one) adds and
    subtracts base-field elements, so a curve whose G2 lies over Fp has no
    add and no sub instance."""
    return ("mul", "from_mont", "neg") if curve in G2_OVER_FP else BASE_FIELD_OPS


# base field spec name -> its ops
BASE_FIELDS = {fp: base_field_ops(curve) for curve, (_, fp) in CURVES.items()}


def instances(curve: str) -> list[str]:
    """The kernel instances of one curve's path, by launch-counter name."""
    fr, fp = CURVES[curve]
    return (
        [f"{op}[{fr}]" for op in FIELD_OPS]
        + [f"{op}[{fp}]" for op in BASE_FIELDS[fp]]
        + [f"butterfly[{fr}]", f"butterfly4[{fr}]", f"ntt_stages[{fr}]"]
        + [f"{op}[{curve}]" for op in CURVE_OPS + MSM_OPS]
    )


def _tag(fp: str) -> str:
    return fp.removesuffix("_fp")


def g2_degree(curve: str) -> int:
    """Base-field components of a G2 coordinate of `curve`: 1 (over Fp), 2
    (over Fp2) or 4 (over Fp4)."""
    return 1 if curve in G2_OVER_FP else 4 if curve in G2_OVER_FP4 else 2


# one counter per kernel instance; a wrapper adds one per launch
LAUNCHES: dict[str, int] = dict.fromkeys([k for c in CURVES for k in instances(c)], 0)

BUILD_INFO: dict = {}

_lib = None

_P = ctypes.c_void_p
_SIGNATURES = {
    **{
        f"ts_field_{op}": (ctypes.c_int, _P, ctypes.c_long, _P, ctypes.c_long, _P, ctypes.c_long, ctypes.c_int, _P)
        for op in ("mul", "add", "sub")
    },
    **{
        f"ts_field_{op}": (ctypes.c_int, _P, ctypes.c_long, _P, ctypes.c_long, ctypes.c_int, _P)
        for op in ("from_mont", "neg")
    },
    "ts_ntt_butterfly": (ctypes.c_int, _P, _P, _P, _P, _P, ctypes.c_long, _P),
    "ts_ntt_butterfly4": (ctypes.c_int, _P, ctypes.c_long, _P),
    "ts_ntt_stages": (
        ctypes.c_int, _P, _P, _P, ctypes.c_long, ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P
    ),
    **{
        f"ts_curve_{_tag(fp)}": (ctypes.c_int, ctypes.c_int, _P, _P, _P, _P, ctypes.c_long, _P)
        for _, fp in CURVES.values()
    },
    **{
        f"ts_msm_{_tag(fp)}_{g}": (ctypes.c_int, _P, _P)
        for _, fp in CURVES.values()
        for g in ("g1", "g2")
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


def _source_hash(flags=NVCC_FLAGS) -> str:
    h = hashlib.sha256()
    for name in sorted(SOURCES + HEADERS):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def _compile(out_dir: Path, so: Path, flags=NVCC_FLAGS) -> dict:
    """One nvcc per source, all started together, then one link; the ptxas
    reports go to ptxas.log. Returns the compile seconds per source."""
    nvcc = _nvcc()
    objs = {src: out_dir / (Path(src).stem + ".o") for src in SOURCES}

    def compile_one(src):
        t0 = time.perf_counter()
        cmd = [nvcc, *flags, "-c", "-o", str(objs[src]), str(CSRC / src)]
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


def build_variant(defines=()) -> tuple[ctypes.CDLL, dict]:
    """Compile (once per source hash and flags) and load the kernel library
    built with the preprocessor `defines`, and its build report. The port's
    own build (``build``) has none; a benchmark that compares builds (e.g.
    "-DTS_MONT_CIOS_C") swaps one in with ``use_library``."""
    flags = NVCC_FLAGS + tuple(defines)
    out_dir = CSRC / "_build" / _source_hash(flags)
    so = out_dir / "libtpusnark_torch_kernels.so"
    t0 = time.perf_counter()
    compiled, source_seconds = False, {}
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        source_seconds = _compile(out_dir, so, flags)
        compiled = True
    log = out_dir / "ptxas.log"
    lib = ctypes.CDLL(str(so))
    for name, sig in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(sig)
        fn.restype = ctypes.c_int
    info = dict(
        path=str(so),
        compiled=compiled,
        seconds=time.perf_counter() - t0,
        source_seconds=source_seconds,
        ptxas=log.read_text() if log.exists() else "",
    )
    return lib, info


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib, info = build_variant()
        BUILD_INFO.update(info)
        use_library(lib)
    return _lib


def use_library(lib: ctypes.CDLL) -> None:
    """Launch every later kernel from `lib` (a build or a build_variant)."""
    global _lib
    _lib = lib
    _FNS.clear()


# entry point name -> its bound function in the loaded library
_FNS: dict = {}


def _fn(name: str):
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(build(), name)
    return fn


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


def _launch(name: str, like: torch.Tensor, fn, *args) -> None:
    """Call the entry point `fn` with `args` and the current stream of the
    card that `like` lies on, with that card current: a kernel launch goes to
    the runtime's current device, which need not be the tensor's."""
    with torch.cuda.device(like.device):
        rc = fn(*args, torch.cuda.current_stream(like.device).cuda_stream)
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


def _field_operand(t, words: int, n: int | None, what: str) -> tuple[int, int]:
    """(word stride, 1 if broadcast) of a field op's operand: an int32 CUDA
    tensor (words, n) whose lanes sit at stride 1 (rows of any stride: a
    column slice), or at stride 0 (one element for every lane)."""
    if not isinstance(t, torch.Tensor) or not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != torch.int32:
        raise TypeError(f"{what}: expected int32 words, got {t.dtype}")
    if t.dim() != 2 or t.shape[0] != words:
        raise ValueError(f"{what}: expected shape ({words}, N), got {tuple(t.shape)}")
    if n is not None and t.shape[1] != n:
        raise ValueError(f"{what}: expected {n} lanes, got {t.shape[1]}")
    sw, sl = t.stride()
    if t.shape[1] > 1 and sl not in (0, 1):
        raise ValueError(f"{what}: expected lanes at stride 1, or 0 (one element for every lane)")
    return sw, int(sl == 0 and t.shape[1] > 1)


def field_binary(op: str, spec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """op in {mul, add, sub}: B1 (mul) and the lazy add/sub, lanewise, into
    a new contiguous (words, N). Either operand may be one element expanded
    to N lanes (stride 0; read once a block) and may sit in rows of any
    stride: nothing is copied."""
    fid, words = _spec(spec, op)
    sa, ba = _field_operand(a, words, None, f"{op} a")
    n = a.shape[1]
    sb, bb = _field_operand(b, words, n, f"{op} b")
    if b.device != a.device:
        raise ValueError(f"{op}: operands on {a.device} and {b.device}")
    out = torch.empty((words, n), dtype=torch.int32, device=a.device)
    if n:
        _launch(
            f"{op}[{spec.name}]",
            a,
            _fn(f"ts_field_{op}"),
            fid,
            a.data_ptr(),
            sa,
            b.data_ptr(),
            sb,
            out.data_ptr(),
            n,
            ba | bb << 1,
        )
    return out


def field_unary(op: str, spec, a: torch.Tensor) -> torch.Tensor:
    """op in {from_mont, neg}: B2 (from_mont) and the lazy negation, into a
    new contiguous (words, N); `a` as a field_binary operand."""
    fid, words = _spec(spec, op)
    sa, ba = _field_operand(a, words, None, f"{op} a")
    n = a.shape[1]
    out = torch.empty((words, n), dtype=torch.int32, device=a.device)
    if n:
        _launch(f"{op}[{spec.name}]", a, _fn(f"ts_field_{op}"), fid, a.data_ptr(), sa, out.data_ptr(), n, ba)
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
            e,
            lib.ts_ntt_butterfly,
            fid,
            e.data_ptr(),
            o.data_ptr(),
            w.data_ptr(),
            a.data_ptr(),
            b.data_ptr(),
            n,
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
        _launch(f"butterfly4[{spec.name}]", x0, lib.ts_ntt_butterfly4, fid, ctypes.addressof(ptrs), n)
    return outs


# Shared memory one block of ts_ntt_stages may hold (csrc/ntt.cu's
# TS_NTT_STAGE_BYTES): 512 elements at 8 to 12 words, 128 threads. Of 24, 48
# and 96 KB (scripts/bench_ntt_passes.py, 2^17 to 2^22) it was the fastest or
# within 1 % of it at every size.
NTT_BLOCK_BYTES = 24 * 1024


def ntt_block_elems(words: int, block_bytes: int = NTT_BLOCK_BYTES) -> int:
    """Elements a block of the NTT pass kernel holds: the largest power of
    two whose words fit `block_bytes` (csrc/ntt.cu's stage_elems)."""
    return 1 << ((block_bytes // (4 * words)).bit_length() - 1)


def ntt_stages(spec, x, table, n: int, s0: int, m: int, out=None):
    """One pass of the NTT: DIT stages s0 .. s0+m-1 over the rows of n lanes
    of bit-reversed x (words, lanes), twiddles from the packed table
    (words, n - 1) (stage s at columns [2^s - 1, 2^(s+1) - 1)). Writes `out`
    (a new tensor, or x itself: the pass may run in place) and returns it."""
    fid, words = _scalar_spec(spec)
    lanes = _check(x, words, what="ntt_stages x")
    k = n.bit_length() - 1
    if n < 2 or n != 1 << k or lanes % n:
        raise ValueError(f"ntt_stages: {lanes} lanes are not rows of a power of two n = {n}")
    elems = ntt_block_elems(words)
    if not (m >= 1 and s0 >= 0 and s0 + m <= k and 1 << m <= elems):
        raise ValueError(f"ntt_stages: stages [{s0}, {s0 + m}) of {k}, at most {elems.bit_length() - 1} a pass")
    _check(table, words, n - 1, "ntt_stages table")
    if table.device != x.device:
        raise ValueError(f"ntt_stages: x on {x.device}, its table on {table.device}")
    if out is None:
        out = torch.empty_like(x)
    else:
        _check(out, words, lanes, "ntt_stages out")
    if not lanes:
        return out
    groups = lanes >> m
    lg_groups = min((elems >> m).bit_length(), (groups - 1).bit_length() + 1) - 1
    _launch(
        f"ntt_stages[{spec.name}]",
        x,
        build().ts_ntt_stages,
        fid,
        x.data_ptr(),
        out.data_ptr(),
        table.data_ptr(),
        lanes,
        n - 1,
        s0,
        m,
        lg_groups,
    )
    return out


# ------------------------------------------------------------------ curves
def curve_of(fp_spec) -> str | None:
    """The curve whose kernels run over base field `fp_spec`, if any."""
    return next((c for c, (_, fp) in CURVES.items() if fp == fp_spec.name), None)


def curve_op(op: str, g2: bool, fp_spec, ins, b3_words, inf=None):
    """B5 (op = add_mixed) and B6 (op = add) over G1 (g2 = False) or G2 of
    the curve whose base field is `fp_spec`.

    ins: the coordinate components of both operands, flattened in order
    (over Fp: X1 Y1 Z1 X2 Y2 [Z2]; over Fp2: X1.c0 X1.c1 Y1.c0 ...; over Fp4:
    X1.c0.c0 X1.c0.c1 X1.c1.c0 X1.c1.c1 Y1.c0.c0 ...), each (words, N).
    b3_words: the uint32 words of 3b (over Fp, words) or 3b' (over Fp2, c0
    then c1, 2 * words; over Fp4, 4 * words in the components' order) in
    Montgomery form. inf: (N,) bool for add_mixed, lanes that return the
    first operand. Returns the output components (X, Y, Z; over Fp2: X.c0,
    X.c1, ...). G2 is over Fp2, except for the curves in G2_OVER_FP and
    G2_OVER_FP4."""
    curve = curve_of(fp_spec)
    if curve is None:
        raise ValueError(f"no CUDA curve kernels over {fp_spec.name}")
    words = SPECS[fp_spec.name][1]
    deg = g2_degree(curve) if g2 else 1
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
            ins[0],
            getattr(lib, f"ts_curve_{_tag(fp_spec.name)}"),
            0 if op == "add" else 1,
            int(g2),
            ctypes.addressof(in_ptrs),
            ctypes.addressof(out_ptrs),
            None if inf is None else inf.data_ptr(),
            ctypes.addressof(b3),
            n,
        )
    return outs


# ------------------------------------------------------------------ MSM
MAX_WORDS = 24  # csrc/mont.cuh


MAX_COMPONENTS = 4  # csrc/curve.cuh: an Fp4 coordinate


class _MsmArgs(ctypes.Structure):
    """csrc/msm.cuh's MsmArgs."""

    _fields_ = [
        ("inp", ctypes.c_uint64 * (6 * MAX_COMPONENTS)),
        ("out", ctypes.c_uint64 * (3 * MAX_COMPONENTS)),
        ("key", ctypes.c_uint64),
        ("order", ctypes.c_uint64),
        ("sign", ctypes.c_uint64),
        ("out_key", ctypes.c_uint64),
        ("n", ctypes.c_int64 * 9),
        ("b3", ctypes.c_uint32 * (2 * MAX_WORDS)),
        ("one", ctypes.c_uint32 * (2 * MAX_WORDS)),
    ]


def _on_card(t) -> bool:
    return isinstance(t, torch.Tensor) and t.device.type == "cuda"


def _check_batched(t, words: int, batch, what: str, dtype=torch.int32) -> None:
    """A contiguous CUDA tensor of shape (words, *batch), or (*batch) where
    words is None; nothing is copied."""
    shape = tuple(batch) if words is None else (words,) + tuple(batch)
    if not _on_card(t):
        raise ValueError(f"{what}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")


class MsmKernels:
    """The fused MSM kernels (csrc/msm.cuh) of one curve and group: the strip
    pass (B5 over affine bases, B6 over projective records), the scan step and
    the window Horner (B6). The launch block with 3b and 1 is built once; a
    call fills in pointers and sizes and launches. Points are lists of
    coordinate components (X, Y[, Z]; over Fp2: X.c0, X.c1, ...; over Fp4:
    X.c0.c0, X.c0.c1, X.c1.c0, X.c1.c1, ...), each int32 (words, *batch) on
    the card; shapes are checked and nothing is copied.

    b3_words, one_words: the uint32 words of 3b and of 1 in Montgomery form
    (over Fp2 and Fp4: the components in that order)."""

    def __init__(self, fp_spec, g2: bool, b3_words, one_words):
        curve = curve_of(fp_spec)
        if curve is None:
            raise ValueError(f"no CUDA curve kernels over {fp_spec.name}")
        self.words = SPECS[fp_spec.name][1]
        self.deg = g2_degree(curve) if g2 else 1
        if len(b3_words) != self.deg * self.words or len(one_words) != self.deg * self.words:
            raise ValueError(f"expected {self.deg * self.words} words of 3b and of 1")
        self.group = "g2" if g2 else "g1"
        self.curve = curve
        self._entry = f"ts_msm_{_tag(fp_spec.name)}_{self.group}"
        self._args = _MsmArgs()
        self._args.b3[: len(b3_words)] = b3_words
        self._args.one[: len(one_words)] = one_words

    def _launch(self, op: str, ins, outs, sizes, like, key=None, order=None, sign=None, out_key=None):
        a = self._args
        for i, t in enumerate(ins):
            a.inp[i] = t.data_ptr()
        for i, t in enumerate(outs):
            a.out[i] = t.data_ptr()
        a.key = 0 if key is None else key.data_ptr()
        a.order = 0 if order is None else order.data_ptr()
        a.sign = 0 if sign is None else sign.data_ptr()
        a.out_key = 0 if out_key is None else out_key.data_ptr()
        for i, v in enumerate(sizes):
            a.n[i] = v
        _launch(
            f"{self.group}_{op}[{self.curve}]",
            like,
            getattr(build(), self._entry),
            MSM_KERNELS[op],
            ctypes.addressof(a),
        )

    def _components(self, comps, coords: int, batch, what: str) -> None:
        if len(comps) != coords * self.deg:
            raise ValueError(f"{what}: expected {coords * self.deg} coordinate components, got {len(comps)}")
        for i, t in enumerate(comps):
            _check_batched(t, self.words, batch, f"{what} component {i}")

    def _strip_outputs(self, W: int, C: int, R: int, device):
        n_rec = (R + 1) * C
        out_key = torch.empty((W, n_rec), dtype=torch.int64, device=device)
        outs = [torch.empty((self.words, W, n_rec), dtype=torch.int32, device=device) for _ in range(3 * self.deg)]
        return out_key, outs

    def strip_mixed(self, skey, order, sign, bases, n_records: int, C: int, R: int, dead: int, sent: int):
        """The strip pass over affine bases. skey, order (int64) and sign
        (bool), each (W, C*R): the sorted keys of every window, the record
        each came from and whether its point is negated. bases: the
        components of (X, Y), each (words, N0) with any strides, the same for
        all (the kernel reads them through the strides); record j is base
        j % N0 for j < n_records and the point (0, 0) past it. dead: the
        first key that reaches no bucket; a record keyed at or past it is
        neither read nor added (its run sums to the identity). sent: the key
        of a row without a flush. Returns the flush keys (W, (R+1)*C) and the
        components of the projective flush points (words, W, (R+1)*C)."""
        W = skey.shape[0]
        _check_batched(skey, None, (W, C * R), "strip keys", torch.int64)
        out_key, outs = self._strip_outputs(W, C, R, skey.device)
        _check_batched(order, None, (W, C * R), "strip order", torch.int64)
        _check_batched(sign, None, (W, C * R), "strip signs", torch.bool)
        if len(bases) != 2 * self.deg:
            raise ValueError(f"strip bases: expected {2 * self.deg} coordinate components, got {len(bases)}")
        n0 = bases[0].shape[-1]
        for i, t in enumerate(bases):
            ok = _on_card(t) and t.dtype == torch.int32
            if not ok or tuple(t.shape) != (self.words, n0) or t.stride() != bases[0].stride():
                raise ValueError(f"strip bases: component {i} is not a (words, N) int32 CUDA tensor in the shared layout")
        if n0 == 0 or not 0 <= n_records <= C * R or n_records % n0:
            raise ValueError("strip bases: the records must tile the bases")
        sw, sp = bases[0].stride()
        self._launch(
            "strip_mixed", bases, outs, (W, C, R, n0, n_records, sw, sp, sent, dead), skey, skey, order, sign, out_key
        )
        return out_key, outs

    def strip(self, skey, comps, C: int, R: int, dead: int, sent: int):
        """The strip pass over sorted projective records: strip s of window w
        walks records [w, s, 0..R). skey (W, C, R) int64 and comps, the
        components of (X, Y, Z), each (words, W, C, R), in any one layout of
        the last two axes inside a window's C*R block (the kernel is given
        their strides: (R, 1) as sorted, (1, C) with a row's lanes side by
        side). dead and sent, and the result, as strip_mixed."""
        if not _on_card(skey) or skey.dtype != torch.int64 or skey.dim() != 3:
            raise ValueError("strip keys: expected an int64 CUDA tensor of shape (W, C, R)")
        W = skey.shape[0]
        layout = next(
            (
                (a, b)
                for a, b in ((R, 1), (1, C))
                if (C == 1 or skey.stride(1) == a) and (R == 1 or skey.stride(2) == b)
            ),
            None,
        )
        if tuple(skey.shape) != (W, C, R) or (W > 1 and skey.stride(0) != C * R) or layout is None:
            raise ValueError(f"strip keys: expected (W, {C}, {R}) with strides (R, 1) or (1, C) inside a window")
        ss, sr = layout
        if len(comps) != 3 * self.deg:
            raise ValueError(f"strip records: expected {3 * self.deg} coordinate components, got {len(comps)}")
        for i, t in enumerate(comps):
            ok = _on_card(t) and t.dtype == torch.int32 and tuple(t.shape) == (self.words, W, C, R)
            if not ok or t.stride()[2:] != skey.stride()[1:] or t[:, :, 0, 0].stride() != (W * C * R, C * R):
                raise ValueError(f"strip records: component {i} is not an int32 CUDA tensor of shape (words, W, C, R) in the keys' layout")
        out_key, outs = self._strip_outputs(W, C, R, skey.device)
        self._launch("strip", comps, outs, (W, C, R, ss, sr, 0, 0, sent, dead), skey, skey, out_key=out_key)
        return out_key, outs

    def scan_step(self, comps, shift: int, width: int, key=None):
        """out[i] = a[i] + a[i + shift] along the last axis where 0 <= i +
        shift < width and (with key, int64 of the batch shape) key[i + shift]
        == key[i]; else a[i]. comps: the components of (X, Y, Z), each
        (words, *batch)."""
        batch = tuple(comps[0].shape[1:])
        self._components(comps, 3, batch, "scan step")
        if key is not None:
            _check_batched(key, None, batch, "scan step keys", torch.int64)
        outs = [torch.empty_like(t) for t in comps]
        lanes = comps[0][0].numel()
        if lanes:
            self._launch("scan_step", comps, outs, (lanes, batch[-1], shift, width), comps[0], key)
        return outs

    def horner(self, comps, c: int):
        """sum_w 2^(c w) S_w by Horner from the top window down. comps: the
        components of the window sums (X, Y, Z), each (words, W, k); returns
        the components of the k results, each (words, k)."""
        if comps[0].dim() != 3 or comps[0].shape[1] < 1:
            raise ValueError("horner: expected components of shape (words, W, k)")
        W, k = comps[0].shape[1:]
        self._components(comps, 3, (W, k), "horner")
        outs = [torch.empty((self.words, k), dtype=torch.int32, device=comps[0].device) for _ in comps]
        if k:
            self._launch("horner", comps, outs, (k, W, c), comps[0])
        return outs
