"""Field specifications (the port's copy of tpusnark/fields/spec.py).

A field is described by one ``FieldSpec`` dataclass: its name, its modulus and
its count of 16-bit limbs, tpusnark's unit. The port stores an element as
``ceil(n_limbs / 2)`` 32-bit words (``fields/tfield.py``); the limb helpers
here serve the host side (``convert.py``, the tests) and keep the specs equal
to tpusnark's, name for name and constant for constant. The reference
(gnark) generates one Montgomery package per curve
(gnark/internal/generator/backend/main.go); here every field is a value.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    """Little-endian base-2^16 limbs of x as uint32 numpy array."""
    x = int(x)
    assert 0 <= x < (1 << (LIMB_BITS * n_limbs)), "value out of limb range"
    out = np.empty((n_limbs,), dtype=np.uint32)
    for i in range(n_limbs):
        out[i] = x & LIMB_MASK
        x >>= LIMB_BITS
    return out


def limbs_to_int(limbs) -> int:
    limbs = np.asarray(limbs)
    x = 0
    for i in range(limbs.shape[-1] - 1, -1, -1):
        x = (x << LIMB_BITS) | int(limbs[..., i])
    return x


def ints_to_limbs(xs, n_limbs: int) -> np.ndarray:
    """Vectorized: list of ints -> (len(xs), n_limbs) uint32 (via bytes)."""
    nbytes = n_limbs * 2
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<u2").reshape(len(xs), n_limbs)
    return arr.astype(np.uint32)


def limbs_to_ints(arr) -> list[int]:
    arr = np.asarray(arr)
    flat = np.ascontiguousarray(arr.reshape(-1, arr.shape[-1]).astype("<u2"))
    nbytes = arr.shape[-1] * 2
    b = flat.tobytes()
    return [int.from_bytes(b[i * nbytes : (i + 1) * nbytes], "little") for i in range(flat.shape[0])]


@dataclass(frozen=True)
class FieldSpec:
    """All host-side constants needed for limb arithmetic mod `modulus`.

    Montgomery radix R = 2^(LIMB_BITS * n_limbs); elements on device are kept
    in Montgomery form (x*R mod p), matching gnark-crypto's convention
    (reference: backend/groth16/bn254/setup.go:128 notes Montgomery form).
    """

    name: str
    modulus: int
    n_limbs: int
    # derived (filled in __post_init__ via object.__setattr__)
    r: int = field(init=False)
    r2: int = field(init=False)
    r3: int = field(init=False)
    pprime: int = field(init=False)  # -p^-1 mod 2^16
    pprime_full: int = field(init=False)  # -p^-1 mod R (full-word Montgomery)
    one_mont: int = field(init=False)

    def __post_init__(self):
        p = self.modulus
        nbits = LIMB_BITS * self.n_limbs
        assert p < (1 << nbits)
        # full-word Montgomery with lazy [0,2p) range is sound iff 4p < R
        assert p < (1 << (nbits - 2)), "modulus too large for limb count (need 4p < R)"
        r = (1 << nbits) % p
        object.__setattr__(self, "r", r)
        object.__setattr__(self, "r2", (r * r) % p)
        object.__setattr__(self, "r3", (r * r * r) % p)
        object.__setattr__(self, "pprime", (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS))
        object.__setattr__(self, "pprime_full", (-pow(p, -1, 1 << nbits)) % (1 << nbits))
        object.__setattr__(self, "one_mont", r % p)

    # ---- host-side helpers -------------------------------------------------
    @functools.cached_property
    def p_limbs(self) -> np.ndarray:
        return int_to_limbs(self.modulus, self.n_limbs)

    def to_mont_int(self, x: int) -> int:
        return (int(x) % self.modulus) * self.r % self.modulus

    def from_mont_int(self, x: int) -> int:
        return int(x) * pow(self.r, -1, self.modulus) % self.modulus

    def encode(self, xs, mont: bool = True) -> np.ndarray:
        """Python ints -> (len, n_limbs) uint32 limbs (Montgomery by default)."""
        if mont:
            xs = [self.to_mont_int(x) for x in xs]
        else:
            xs = [int(x) % self.modulus for x in xs]
        return ints_to_limbs(xs, self.n_limbs)

    def decode(self, arr, mont: bool = True) -> list[int]:
        vals = limbs_to_ints(arr)
        if mont:
            inv_r = pow(self.r, -1, self.modulus)
            return [v * inv_r % self.modulus for v in vals]
        return [v % self.modulus for v in vals]


# --- concrete fields --------------------------------------------------------

# BN254 scalar field (order of G1/G2; the SNARK "fr").
# reference: gnark-crypto ecc/bn254/fr, used at constraint/bn254/solver.go:35
BN254_FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# BN254 base field ("fp"), coordinates of curve points.
BN254_FP_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583

BN254_FR = FieldSpec("bn254_fr", BN254_FR_MOD, 16)
BN254_FP = FieldSpec("bn254_fp", BN254_FP_MOD, 16)

# BLS12-381 (second curve family in scope, SURVEY.md §7 step 9)
BLS12_381_FR_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
BLS12_381_FP_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# 255-bit modulus: 17 limbs so the full-word-Montgomery bound 4p < 2^(16*17) holds
BLS12_381_FR = FieldSpec("bls12_381_fr", BLS12_381_FR_MOD, 17)
BLS12_381_FP = FieldSpec("bls12_381_fp", BLS12_381_FP_MOD, 24)

# the native 2-chain (reference backend.go:28-33): BW6-761's scalar field IS
# BLS12-377's base field, making BLS12-377 point arithmetic native inside
# BW6-761 circuits (std/algebra/native)
BLS12_377_FR_MOD = 0x12AB655E9A2CA55660B44D1E5C37B00159AA76FED00000010A11800000000001
BLS12_377_FP_MOD = 0x01AE3A4617C510EAC63B05C06CA1493B1A22D9F300F5138F1EF3622FBA094800170B5D44300000008508C00000000001
BW6_761_FP_MOD = 0x122E824FB83CE0AD187C94004FAFF3EB926186A81D14688528275EF8087BE41707BA638E584E91903CEBAFF25B423048689C8ED12F9FD9071DCD3DC73EBFF2E98A116C25667A8F8160CF8AEEAF0A437E6913E6870000082F49D00000000008B

BLS12_377_FR = FieldSpec("bls12_377_fr", BLS12_377_FR_MOD, 16)
BLS12_377_FP = FieldSpec("bls12_377_fp", BLS12_377_FP_MOD, 24)
BW6_761_FR = FieldSpec("bw6_761_fr", BLS12_377_FP_MOD, 24)  # = BLS12-377 Fp
BW6_761_FP = FieldSpec("bw6_761_fp", BW6_761_FP_MOD, 48)

# BLS24-315 / BLS24-317 (G2 over Fp4, GT in Fp24) and BW6-633 (outer curve
# of the BLS24-315 2-chain: its fr IS BLS24-315's fp) — the remaining three
# of the reference's seven curves (backend/backend.go:28-33). Moduli derived
# from the seeds in curves/bls24*.py / bw6633.py; BLS24-315's cross-checked
# against the reference's emparams.go:262-283.
BLS24_315_FR_MOD = 0x196DEAC24A9DA12B25FC7EC9CF927A98C8C480ECE644E36419D0C5FD00C00001
BLS24_315_FP_MOD = 0x4C23A02B586D650D3F7498BE97C5EAFDEC1D01AA27A1AE0421EE5DA52BDE5026FE802FF40300001
BLS24_317_FR_MOD = 0x443F917EA68DAFC2D0B097F28D83CD491CD1E79196BF0E7AF000000000000001
BLS24_317_FP_MOD = 0x1058CA226F60892CF28FC5A0B7F9D039169A61E684C73446D6F339E43424BF7E8D512E565DAB2AAB
BW6_633_FP_MOD = 0x126633CC0F35F63FC1A174F01D72AB5A8FCD8C75D79D2C74E59769AD9BBDA2F8152A6C0FADEA490B8DA9F5E83F57C497E0E8850EDBDA407D7B5CE7AB839C2253D369BD31147F73CD74916EA4570000D

BLS24_315_FR = FieldSpec("bls24_315_fr", BLS24_315_FR_MOD, 16)
BLS24_315_FP = FieldSpec("bls24_315_fp", BLS24_315_FP_MOD, 20)
# 255-bit r: 17 limbs so 4p < R holds (same reasoning as BLS12-381 fr)
BLS24_317_FR = FieldSpec("bls24_317_fr", BLS24_317_FR_MOD, 17)
BLS24_317_FP = FieldSpec("bls24_317_fp", BLS24_317_FP_MOD, 20)
BW6_633_FR = FieldSpec("bw6_633_fr", BLS24_315_FP_MOD, 20)  # = BLS24-315 fp
BW6_633_FP = FieldSpec("bw6_633_fp", BW6_633_FP_MOD, 40)

# Tiny field for exhaustive kernel tests — the analog of gnark's generated
# tinyfield (modulus 0x2f) at gnark/internal/tinyfield/
# (generated by internal/generator/backend/main.go:66-79).
TINY_MOD = 0x2F
TINY = FieldSpec("tiny", TINY_MOD, 2)  # 2 limbs so mont paths are exercised
