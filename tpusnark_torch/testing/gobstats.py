"""Minimal Go `encoding/gob` decoder for the reference's constraint-count
regression table (gnark/internal/stats/latest.stats).

The file is `gob.Encode(map[string][4][8]snippetStats)` with
snippetStats{NbConstraints, NbInternalWires int} (stats.go:29-60: row index
is backend.ID UNKNOWN/GROTH16/PLONK/PLONKFRI, column is CurveIdx order
BN254, BLS12-377, BLS12-381, BLS24-315, BW6-761, BW6-633, BLS24-317 + a
trailing unused slot). This is the only externally-produced machine-readable
constraint-count artifact in the reference repo; tests use it to
cross-validate gadget constraint counts against gnark's. Only the gob subset this file needs is implemented.

The port's copy of tpusnark/testing/gobstats.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

BACKENDS = ["unknown", "groth16", "plonk", "plonkfri"]
CURVES = [
    "bn254",
    "bls12-377",
    "bls12-381",
    "bls24-315",
    "bw6-761",
    "bw6-633",
    "bls24-317",
    "_",
]


class _R:
    def __init__(self, data: bytes):
        self.d = data
        self.i = 0

    def byte(self) -> int:
        b = self.d[self.i]
        self.i += 1
        return b

    def take(self, n: int) -> bytes:
        out = self.d[self.i : self.i + n]
        assert len(out) == n, "gob: truncated"
        self.i += n
        return out

    def uint(self) -> int:
        """gob unsigned int: one byte if < 128, else (256-b) big-endian
        bytes follow."""
        b = self.byte()
        if b < 0x80:
            return b
        n = 256 - b
        assert 1 <= n <= 8, f"gob: bad uint prefix {b:#x}"
        return int.from_bytes(self.take(n), "big")

    def int_(self) -> int:
        u = self.uint()
        return ~(u >> 1) if (u & 1) else (u >> 1)

    def string(self) -> str:
        n = self.uint()
        return self.take(n).decode()

    def eof(self) -> bool:
        return self.i >= len(self.d)


def _snippet_struct(r: _R) -> tuple[int, int]:
    """Struct with delta-encoded field numbers, 0-terminated."""
    vals = [0, 0]  # NbConstraints, NbInternalWires
    fld = -1
    while True:
        delta = r.uint()
        if delta == 0:
            return tuple(vals)
        fld += delta
        assert fld < 2, "gob: unexpected field"
        vals[fld] = r.int_()


def load_stats(path: str) -> dict:
    """-> {snippet_name: {backend: {curve: (nb_constraints, nb_wires)}}}"""
    data = open(path, "rb").read()
    r = _R(data)
    # skip type-definition messages (negative type ids) until the value
    while True:
        n = r.uint()  # message byte count
        start = r.i
        tid = r.int_()
        if tid >= 0:
            break
        r.i = start + n  # skip the definition body
    r.uint()  # delta 0 preceding a non-struct top-level value
    out = {}
    count = r.uint()
    for _ in range(count):
        name = r.string()
        n_out = r.uint()
        assert n_out == len(BACKENDS), f"gob: outer array {n_out}"
        table = {}
        for b in BACKENDS:
            n_in = r.uint()
            assert n_in == len(CURVES), f"gob: inner array {n_in}"
            row = {}
            for c in CURVES:
                row[c] = _snippet_struct(r)
            table[b] = row
        out[name] = table
    return out
