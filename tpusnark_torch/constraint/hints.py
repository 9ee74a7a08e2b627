"""Hint registry: named out-of-circuit callbacks.

gnark analog: gnark/constraint/solver/hint_registry.go:21-49 —
hints are global functions keyed by an ID derived from their name, so a
deserialized constraint system can re-bind them. Here the key is the
qualified function name (stable across processes); ids are FNV-1a hashes of
it like gnark's solver.GetHintID.

The port's copy of tpusnark/constraint/hints.py: same code, imports inside tpusnark_torch.
"""

from __future__ import annotations

_REGISTRY: dict[str, object] = {}


def fnv1a(name: str) -> int:
    h = 0xCBF29CE484222325
    for b in name.encode():
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def hint_name(fn) -> str:
    return f"{getattr(fn, '__module__', '?')}.{getattr(fn, '__qualname__', repr(fn))}"


def register_hint(fn, name: str | None = None):
    """Register for lookup after deserialization. Returns the name key."""
    key = name or hint_name(fn)
    existing = _REGISTRY.get(key)
    if existing is not None and existing is not fn:
        raise ValueError(f"hint {key!r} already registered with a different function")
    _REGISTRY[key] = fn
    return key


def get_hint(name: str):
    fn = _REGISTRY.get(name)
    if fn is None and ".bits_hint_" in name:
        # parametric bit-decomposition hints re-materialize on demand
        nbits = int(name.rsplit("_", 1)[1])
        return bits_hint_factory(nbits)
    if fn is None and ".batch_invert_hint_" in name:
        return batch_invert_hint_factory(int(name.rsplit("_", 1)[1]))
    if fn is None:
        raise KeyError(
            f"hint {name!r} not registered; import its module or register_hint() it"
        )
    return fn


def registered() -> list[str]:
    return sorted(_REGISTRY)


# ---- built-in hints (the ones the builders emit) ----------------------------
def inv_hint(p, ins):
    (x,) = ins
    return [pow(x, -1, p) if x % p else 0]


def div_unchecked_hint(p, ins):
    """a/b with 0/0 -> 0 (the DivUnchecked witness; constrained res*b == a)."""
    a, b = ins
    return [a * pow(b, -1, p) % p if b % p else 0]


_BATCH_INV_CACHE: dict[int, object] = {}


def batch_invert_hint_factory(n: int):
    fn = _BATCH_INV_CACHE.get(n)
    if fn is None:

        def batch_invert_hint(p, ins):
            return [pow(x, -1, p) if x % p else 0 for x in ins]

        batch_invert_hint.__qualname__ = f"batch_invert_hint_{n}"
        register_hint(batch_invert_hint)
        _BATCH_INV_CACHE[n] = batch_invert_hint
        fn = batch_invert_hint
    return fn


_BITS_CACHE: dict[int, object] = {}


def bits_hint_factory(nbits: int):
    fn = _BITS_CACHE.get(nbits)
    if fn is None:

        def bits_hint(p, ins):
            (x,) = ins
            return [(x >> i) & 1 for i in range(nbits)]

        bits_hint.__qualname__ = f"bits_hint_{nbits}"
        register_hint(bits_hint)
        _BITS_CACHE[nbits] = bits_hint
        fn = bits_hint
    return fn


def bsb22_placeholder(p, ins):
    """BSB22 commitment placeholder hint (gnark
    frontend/cs/commitment.go:15 Bsb22CommitmentComputePlaceholder): the
    prover overrides it with the real Pedersen-commit + hash-to-field
    computation. Outside a prover (test engine / solver-only runs) it
    returns a deterministic nonzero stand-in derived from the inputs so
    solve-only flows work — proofs made without the override are unsound
    and will fail verification, exactly like the reference's random
    placeholder."""
    import hashlib

    h = hashlib.sha256(b"bsb22-placeholder")
    for x in ins:
        h.update(int(x % p).to_bytes((p.bit_length() + 7) // 8, "big"))
    v = int.from_bytes(h.digest(), "big") % p
    return [v if v else 1]


register_hint(inv_hint)
register_hint(div_unchecked_hint)
register_hint(bsb22_placeholder)
