"""Groth16 key and proof containers, and the device residency of the proving
key's point tables (counterpart of tpusnark/backend/groth16/keys.py).

Reference shapes: ProvingKey/VerifyingKey at
gnark/backend/groth16/bn254/setup.go:35-82 and the icicle device-resident
variant gnark/backend/groth16/bn254/icicle/provingkey.go:11-36.

Host-side points are python-int affine tuples ((x, y) | None; G2 uses the
curve's Fp2 or Fp4 coordinates, or plain ints where G2 lies over Fp): the
serializable form. The containers are the port's own copies of tpusnark's
dataclasses, field for field. Device residency is lazy and per device: on
the first prove the tables are encoded into word tensors and cached on the
key object; ``setup`` installs the tables it computed on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ... import kernels
from ...curves.config import get_curve
from ...curves.encoding import g1_to_device, g2_to_device, g4_to_device
from ...fields.tfield import canonical_device, get_field


@dataclass
class VerifyingKey:
    alpha_g1: tuple
    beta_g2: tuple
    gamma_g2: tuple
    delta_g2: tuple
    k: list  # G1 points: one per public wire (index 0 = the constant wire),
    # then one per BSB22 commitment wire (verifier-injected challenges)
    # gnark carries G1.Beta/Delta on the VK purely for wire compatibility
    # ("unused, here for compatibility purposes", setup.go:66, = pk.G1.Beta/
    # Delta at setup.go:326-327); we store them so vk bytes match gnark's.
    beta_g1: tuple | None = None
    delta_g1: tuple | None = None
    # BSB22 (reference verify.go:76-108): Pedersen vk + per-commitment index
    # lists into the extended public witness for the challenge hash
    commitment_key: object | None = None
    public_and_commitment_committed: list = field(default_factory=list)

    @property
    def n_public(self) -> int:
        return len(self.k)


@dataclass
class ProvingKey:
    alpha_g1: tuple
    beta_g1: tuple
    delta_g1: tuple
    beta_g2: tuple
    delta_g2: tuple
    a: list  # G1, per wire: A_w(t)
    b1: list  # G1, per wire: B_w(t)
    b2: list  # G2, per wire: B_w(t)
    k: list  # G1, per uncommitted private wire: (beta*A_w+alpha*B_w+C_w)/delta
    z: list  # G1, length n-1: t^i * Z_H(t)/delta
    domain_n: int = 0
    # BSB22: wire ids backing pk.k (identity when no commitments), and the
    # Pedersen proving keys (basis = K of committed wires, setup.go:146-197)
    k_wires: list | None = None
    commitment_keys: list = field(default_factory=list)
    # which curve the key was set up over (gnark's CurveID)
    curve: str = "bn254"
    # lazy device residency (icicle.go:31-130 analog): device -> tables
    _dev: dict = field(default_factory=dict, repr=False)


@dataclass
class Proof:
    ar: tuple  # G1
    krs: tuple  # G1
    bs: tuple  # G2
    # BSB22 (reference Proof, prove.go:46-56): one Pedersen commitment per
    # frontend Commit plus a single folded proof of knowledge
    commitments: list = field(default_factory=list)
    commitment_pok: tuple | None = None


def ported_curve(name: str):
    """The CurveConfig of `name`, if the port has its kernels."""
    if name not in kernels.CURVES:
        raise NotImplementedError(
            f"curve {name}: its kernels are not ported (ported: {', '.join(kernels.CURVES)})"
        )
    return get_curve(name)


def set_device_tables(pk, device, tables: dict) -> None:
    """Install tables (a, b1, b2, k, z as affine (X, Y, inf)) for `device`."""
    pk._dev[str(canonical_device(device))] = tables


def device_tables(pk, device) -> dict:
    """Point tables of pk on `device`, encoded from the host points once
    over the base field of pk's curve."""
    cfg = ported_curve(pk.curve)
    key = str(canonical_device(device))
    if key not in pk._dev:
        fp = get_field(cfg.fp_spec)
        # BW6: G2 points have plain Fp coordinates (sextic twist over Fp):
        # encode them with the G1 layout; BLS24: Fp4 coordinates
        enc_g2 = g1_to_device if cfg.g2_over_fp else g4_to_device if cfg.g2_fp4 else g2_to_device
        pk._dev[key] = {
            "a": g1_to_device(pk.a, fp, device),
            "b1": g1_to_device(pk.b1, fp, device),
            "b2": enc_g2(pk.b2, fp, device),
            "k": g1_to_device(pk.k, fp, device),
            "z": g1_to_device(pk.z, fp, device),
        }
    return pk._dev[key]
