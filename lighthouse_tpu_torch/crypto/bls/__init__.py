"""BLS12-381 host oracle and public API of the PyTorch port.

``constants``, ``fields``, ``curve``, ``hash_to_curve``, ``pairing`` and
``keys`` are copies of the JAX package's pure-Python modules of the same
names (deserialization with subgroup checks, the RFC 9380 hash-to-G2
oracle, the Frobenius and psi constants), kept here so the port imports
nothing of ``lighthouse_tpu``. ``api`` is the subset batch verification
needs.
"""

from .api import (
    AggregateSignature,
    BlsError,
    PublicKey,
    SecretKey,
    Signature,
    SignatureSet,
    bisect_verify_sets,
    verify_signature_sets,
    verify_signature_sets_python,
    verify_signature_sets_triaged,
)

__all__ = [
    "AggregateSignature",
    "BlsError",
    "PublicKey",
    "SecretKey",
    "Signature",
    "SignatureSet",
    "bisect_verify_sets",
    "verify_signature_sets",
    "verify_signature_sets_python",
    "verify_signature_sets_triaged",
]
