"""Public BLS API of the PyTorch port: key, signature and set types plus the
batch entry points.

This is the subset of the JAX package's ``crypto/bls/api.py`` that batch
verification needs. The types are the same; ``verify_signature_sets`` and
the per-set entries ``verify_signature_sets_triaged`` and
``bisect_verify_sets`` are bound to
:class:`lighthouse_tpu_torch.torch_backend.TorchBackend` instead of a
backend registry, and ``verify_signature_sets_python`` is the pure-Python
RLC oracle the port is held to.

Semantics preserved:
  * PublicKey deserialization subgroup-checks and rejects the point at
    infinity.
  * Signature deserialization is lazy about subgroup checks; they happen at
    verification time.
  * An infinity AggregateSignature, or a set with zero pubkeys, never
    verifies in verify_signature_sets.
"""

from __future__ import annotations

import secrets
from dataclasses import dataclass

from . import keys as _keys
from .constants import INFINITY_PUBLIC_KEY, RAND_BITS
from .curve import (
    AffinePoint,
    DeserializeError,
    g1_from_compressed,
    g1_generator,
    g1_infinity,
    g1_subgroup_check,
    g1_to_compressed,
    g2_from_compressed,
    g2_infinity,
    g2_subgroup_check,
    g2_to_compressed,
)
from .hash_to_curve import hash_to_g2
from .pairing import final_exponentiation, miller_loop


class BlsError(ValueError):
    pass


class PublicKey:
    """A validated (on-curve, in-subgroup, non-infinity) G1 public key."""

    __slots__ = ("point", "_bytes")

    def __init__(self, point: AffinePoint, raw: bytes | None = None):
        self.point = point
        self._bytes = raw

    @classmethod
    def from_bytes(cls, data: bytes) -> "PublicKey":
        if data == INFINITY_PUBLIC_KEY:
            raise BlsError("public key is the point at infinity")
        try:
            pt = g1_from_compressed(data, allow_infinity=False)
        except DeserializeError as e:
            raise BlsError(str(e)) from None
        if not g1_subgroup_check(pt):
            raise BlsError("public key fails subgroup check")
        return cls(pt, bytes(data))

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = g1_to_compressed(self.point)
        return self._bytes

    def __eq__(self, other):
        return isinstance(other, PublicKey) and self.to_bytes() == other.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"PublicKey({self.to_bytes().hex()})"


class Signature:
    """A G2 signature; subgroup check deferred to verification time."""

    __slots__ = ("point", "_bytes", "_subgroup_ok")

    def __init__(self, point: AffinePoint, raw: bytes | None = None):
        self.point = point
        self._bytes = raw
        self._subgroup_ok: bool | None = None

    @classmethod
    def from_bytes(cls, data: bytes) -> "Signature":
        try:
            pt = g2_from_compressed(data, allow_infinity=True)
        except DeserializeError as e:
            raise BlsError(str(e)) from None
        return cls(pt, bytes(data))

    def to_bytes(self) -> bytes:
        if self._bytes is None:
            self._bytes = g2_to_compressed(self.point)
        return self._bytes

    def is_infinity(self) -> bool:
        return self.point.infinity

    def subgroup_check(self) -> bool:
        if self._subgroup_ok is None:
            self._subgroup_ok = self.point.infinity or g2_subgroup_check(self.point)
        return self._subgroup_ok

    def verify(self, pk: PublicKey, message: bytes) -> bool:
        if self.point.infinity or not self.subgroup_check():
            return False
        return _keys.verify_point(pk.point, message, self.point)

    def __eq__(self, other):
        return isinstance(other, Signature) and self.to_bytes() == other.to_bytes()

    def __hash__(self):
        return hash(self.to_bytes())

    def __repr__(self):
        return f"Signature({self.to_bytes().hex()})"


class AggregateSignature:
    """Running aggregate of G2 signatures; starts at infinity."""

    __slots__ = ("point",)

    def __init__(self, point: AffinePoint | None = None):
        self.point = point if point is not None else g2_infinity()

    @classmethod
    def infinity(cls) -> "AggregateSignature":
        return cls(g2_infinity())

    @classmethod
    def from_bytes(cls, data: bytes) -> "AggregateSignature":
        return cls(Signature.from_bytes(data).point)

    @classmethod
    def aggregate(cls, sigs: list[Signature]) -> "AggregateSignature":
        """IETF Aggregate: errors on the empty list."""
        if not sigs:
            raise BlsError("cannot aggregate an empty signature list")
        acc = cls.infinity()
        for s in sigs:
            acc.add_assign(s)
        return acc

    def to_bytes(self) -> bytes:
        return g2_to_compressed(self.point)

    def is_infinity(self) -> bool:
        return self.point.infinity

    def add_assign(self, sig: Signature) -> None:
        self.point = self.point.add(sig.point)

    def __eq__(self, other):
        return isinstance(other, AggregateSignature) and self.to_bytes() == other.to_bytes()

    def __repr__(self):
        return f"AggregateSignature({self.to_bytes().hex()})"


class SecretKey:
    __slots__ = ("sk",)

    def __init__(self, sk: int):
        self.sk = sk

    @classmethod
    def generate(cls) -> "SecretKey":
        return cls(_keys.keygen(secrets.token_bytes(32)))

    @classmethod
    def from_int(cls, sk: int) -> "SecretKey":
        return cls(sk)

    @classmethod
    def from_bytes(cls, data: bytes) -> "SecretKey":
        try:
            return cls(_keys.sk_from_bytes(data))
        except ValueError as e:
            raise BlsError(str(e)) from None

    def to_bytes(self) -> bytes:
        return _keys.sk_to_bytes(self.sk)

    def public_key(self) -> PublicKey:
        return PublicKey(_keys.sk_to_pk_point(self.sk))

    def sign(self, message: bytes) -> Signature:
        return Signature(_keys.sign_point(self.sk, message))


@dataclass
class SignatureSet:
    """{aggregate signature, contributing pubkeys, 32-byte message}: the
    uniform unit of batch verification."""

    signature: AggregateSignature
    signing_keys: list[PublicKey]
    message: bytes
    # Validator indices parallel to signing_keys, when the caller knows
    # them: the backend then gathers the pubkeys from the registered device
    # table (``blsrt.DevicePubkeyTable``) instead of packing coordinates.
    signing_key_indices: list[int] | None = None

    @classmethod
    def single_pubkey(cls, signature, signing_key: PublicKey, message: bytes,
                      index: int | None = None):
        sig = signature if isinstance(signature, AggregateSignature) else AggregateSignature(signature.point)
        return cls(sig, [signing_key], message,
                   None if index is None else [index])

    @classmethod
    def multiple_pubkeys(cls, signature, signing_keys: list[PublicKey],
                         message: bytes, indices: list[int] | None = None):
        sig = signature if isinstance(signature, AggregateSignature) else AggregateSignature(signature.point)
        return cls(sig, signing_keys, message, indices)


def _rand_scalar() -> int:
    """Nonzero RAND_BITS-bit blinding scalar from the host CSPRNG."""
    while True:
        r = secrets.randbits(RAND_BITS)
        if r != 0:
            return r


def verify_signature_sets(sets: list[SignatureSet], device=None) -> bool:
    """THE batch entry point: RLC multi-aggregate verification on the card
    (or on ``device``, e.g. ``"cpu"``), through
    :class:`~lighthouse_tpu_torch.torch_backend.TorchBackend`."""
    from ...torch_backend import TorchBackend

    return TorchBackend(device).verify_signature_sets(sets)


# The host bisection's policy (reference: crypto/bls/api.py): spans of at
# most BISECT_LINEAR_CUTOFF sets verify one set at a time, and the work, in
# set verifications, stops halving past BISECT_WORK_BUDGET per set.
BISECT_LINEAR_CUTOFF = 2
BISECT_WORK_BUDGET = 6


def bisect_verify_sets(sets: list[SignatureSet], device=None,
                       budget: list[int] | None = None) -> list[bool]:
    """Per-set verdicts by budgeted halving over :func:`verify_signature_sets`
    on ``device``: a batch that verifies makes all its sets valid in one
    call; otherwise each half recurses, packing and hashing again (what the
    grouped triage avoids). Once the budget is spent, or a span is down to
    ``BISECT_LINEAR_CUTOFF`` sets, its sets verify one by one."""
    if not sets:
        return []
    if budget is None:
        budget = [BISECT_WORK_BUDGET * len(sets)]
    budget[0] -= len(sets)
    if verify_signature_sets(sets, device=device):
        return [True] * len(sets)
    if len(sets) == 1:
        return [False]
    if len(sets) <= BISECT_LINEAR_CUTOFF or budget[0] <= 0:
        return [verify_signature_sets([s], device=device) for s in sets]
    mid = len(sets) // 2
    return (bisect_verify_sets(sets[:mid], device, budget)
            + bisect_verify_sets(sets[mid:], device, budget))


def verify_signature_sets_triaged(sets: list[SignatureSet],
                                  device=None) -> list[bool]:
    """Per-set verdicts at the cost of a batch: grouped verdicts from one
    device dispatch, refined on the poisoned groups only
    (``TorchBackend.verify_signature_sets_triaged``), each verdict that of
    the set verified alone."""
    from ...torch_backend import TorchBackend

    return TorchBackend(device).verify_signature_sets_triaged(sets)


def verify_signature_sets_python(sets: list[SignatureSet]) -> bool:
    """Pure-Python RLC batch verification (the oracle)."""
    if not sets:
        return False
    pairs = []
    sig_acc = g2_infinity()
    for s in sets:
        if not s.signing_keys:
            return False
        if s.signature.is_infinity():
            return False
        if not g2_subgroup_check(s.signature.point):
            return False
        r = _rand_scalar()
        pk_acc = g1_infinity()
        for pk in s.signing_keys:
            pk_acc = pk_acc.add(pk.point)
        pairs.append((pk_acc.mul(r), hash_to_g2(s.message)))
        sig_acc = sig_acc.add(s.signature.point.mul(r))
    f = miller_loop(g1_generator().neg(), sig_acc)
    for p_g1, q_g2 in pairs:
        f = f * miller_loop(p_g1, q_g2)
    return final_exponentiation(f).is_one()
