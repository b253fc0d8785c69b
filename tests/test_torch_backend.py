"""The port's batch verifier as a whole against the JAX package.

``TorchBackend(device="cpu")`` runs the classic verify path with the plain
versions of the kernels. Its verdicts must equal the pure-Python RLC
oracle's and ``JaxBackend``'s (classic off-TPU, oracle hashing). The sets
are the ones of ``tests/test_jax_backend.py`` (secret keys 7-9, messages
0x11../0x22.., the (S=2, K=2) bucket). Set objects come from the JAX
package's API: the port reads them by duck typing.

The live comparisons with the JAX verify program are in the slow tier:
tracing that program costs about 90 s on a CPU, once per test module (the
persistent cache keeps only its compile, and conftest drops JAX's
in-memory caches between modules). ``test_jax_backend.py`` holds the JAX
verdicts to the same oracle on the same cases in the fast tier.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu import jax_backend
from lighthouse_tpu.crypto.bls.api import (
    AggregateSignature,
    SecretKey,
    SignatureSet,
    verify_signature_sets_python,
)
from lighthouse_tpu.crypto.bls.backends import get_backend
from lighthouse_tpu.crypto.bls.curve import g1_infinity, g2_infinity
from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu.ops.points import g1_to_dev, g2_to_dev
from lighthouse_tpu_torch import interop, torch_backend
from lighthouse_tpu_torch.crypto.bls import api as torch_api
from lighthouse_tpu_torch.torch_backend import TorchBackend

SKS = [SecretKey.from_int(i + 7) for i in range(3)]
PKS = [sk.public_key() for sk in SKS]
M0 = b"\x11" * 32
M1 = b"\x22" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs thousands of tiny ops; intra-op threads
    only spin on them (and fight the other test workers for cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _valid_sets():
    s0 = SignatureSet.single_pubkey(SKS[0].sign(M0), PKS[0], M0)
    agg = AggregateSignature.aggregate([SKS[1].sign(M1), SKS[2].sign(M1)])
    s1 = SignatureSet.multiple_pubkeys(agg, [PKS[1], PKS[2]], M1)
    return [s0, s1]


def _case(name):
    sets = _valid_sets()
    s0 = sets[0]
    if name == "wrong_message":
        sets[0] = SignatureSet.single_pubkey(SKS[0].sign(M0), PKS[0], M1)
    elif name == "wrong_key":
        sets[0] = SignatureSet.single_pubkey(SKS[0].sign(M0), PKS[1], M0)
    elif name == "poisoned_duplicate":
        # both sets carry M0; the second signed M1: the dedup may alias
        # the hash rows, never the verdicts
        bad = AggregateSignature.aggregate([SKS[1].sign(M1), SKS[2].sign(M1)])
        sets = [s0, SignatureSet.multiple_pubkeys(bad, [PKS[1], PKS[2]], M0)]
    elif name == "honest_duplicate":
        ok = AggregateSignature.aggregate([SKS[1].sign(M0), SKS[2].sign(M0)])
        sets = [s0, SignatureSet.multiple_pubkeys(ok, [PKS[1], PKS[2]], M0)]
    return sets


CASES = [
    ("valid", True),
    ("wrong_message", False),
    ("wrong_key", False),
    ("poisoned_duplicate", False),
    ("honest_duplicate", True),
]


@pytest.mark.parametrize("name, want", CASES)
def test_verdict_matches_oracle(name, want):
    sets = _case(name)
    be = TorchBackend(device="cpu")
    assert verify_signature_sets_python(sets) is want
    assert be.verify_signature_sets(sets) is want
    assert be.last_operand_device == torch.device("cpu")
    assert set(be.last_stage_seconds) == {
        "pack", "hash_to_curve", "htc_dedup", "htc_map", "htc_cofactor",
        "scalars", "dispatch", "device_sync"
    }


def test_structural_rejections_host_side():
    be = TorchBackend(device="cpu")
    jax_be = get_backend("jax")
    inf_sig = SignatureSet(AggregateSignature.infinity(), [PKS[0]], M0)
    no_keys = SignatureSet(AggregateSignature.aggregate([SKS[0].sign(M0)]), [], M0)
    for sets in ([], [inf_sig], [no_keys]):
        assert not verify_signature_sets_python(sets)
        assert not jax_be.verify_signature_sets(sets)
        assert not be.verify_signature_sets(sets)
        assert be.last_stage_seconds == {}  # rejected before any stage


def test_default_device_is_the_card():
    """No device means the card: without CUDA the constructor raises
    instead of running on the host."""
    if torch.cuda.is_available():
        assert TorchBackend().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TorchBackend()


def _packed_valid_operands():
    """The numpy operands JaxBackend._dispatch builds for _valid_sets()
    (no input caches), with fixed RLC bits."""
    sets = _valid_sets()
    S, K = 2, 2
    rows = []
    for s in sets:
        row = [pk.point for pk in s.signing_keys]
        rows += row + [g1_infinity()] * (K - len(row))
    px, py, pinf = g1_to_dev(rows)
    sx, sy, sinf = g2_to_dev([s.signature.point for s in sets])
    mx, my, minf = g2_to_dev([hash_to_g2(s.message) for s in sets])
    rng = np.random.default_rng(2024)
    r_bits = rng.integers(0, 2, size=(S, 64), dtype=np.int32)
    r_bits[:, 0] = 1
    return (px.reshape(S, K, 48), py.reshape(S, K, 48), pinf.reshape(S, K),
            sx, sy, sinf, mx, my, minf, r_bits), sets


@pytest.mark.slow
@pytest.mark.parametrize("name, want", CASES)
def test_verdict_matches_jax_backend(name, want):
    sets = _case(name)
    assert bool(get_backend("jax").verify_signature_sets(sets)) is want
    assert TorchBackend(device="cpu").verify_signature_sets(sets) is want


@pytest.mark.slow
def test_core_matches_jax_core_on_identical_operands():
    ops_np, _ = _packed_valid_operands()
    px, py, pinf, sx, sy, sinf, mx, my, minf, r_bits = ops_np
    want = bool(jax_backend._verify_jit(
        (px, py), pinf, (sx, sy), sinf, (mx, my), minf, r_bits
    ))
    ops = interop.operands_from_numpy(*ops_np, device="cpu")
    assert bool(torch_backend._verify_core(*ops)) == want is True


def test_aggregates_match_oracle_on_jax_operands():
    """The JAX dispatch's packed operands cross over unchanged, and the
    port's canonical affine aggregates equal the host oracle's, byte for
    byte."""
    ops_np, sets = _packed_valid_operands()
    ops = interop.operands_from_numpy(*ops_np, device="cpu")
    for t, a in zip(
        (ops[0][0], ops[0][1], ops[1], ops[2][0], ops[4][1], ops[6]),
        (ops_np[0], ops_np[1], ops_np[2], ops_np[3], ops_np[7], ops_np[9]),
    ):
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)
    ax, ay, ainf = torch_backend.aggregate_pubkeys(ops[0], ops[1])
    agg = []
    for s in sets:
        acc = g1_infinity()
        for pk in s.signing_keys:
            acc = acc.add(pk.point)
        agg.append(acc)
    ex, ey, einf = g1_to_dev(agg)
    np.testing.assert_array_equal(ax.numpy(), ex)
    np.testing.assert_array_equal(ay.numpy(), ey)
    np.testing.assert_array_equal(ainf.numpy(), einf)


def test_dedup_plan_matches_reference():
    from lighthouse_tpu import blsrt
    from lighthouse_tpu_torch import dedup

    msgs = [M0, M1, M0, b"\x33" * 32, M1, M0]
    mine, ref = dedup.dedup_plan(msgs), blsrt.dedup_plan(msgs)
    assert mine.distinct == ref.distinct and mine.enabled and mine.n == 6
    np.testing.assert_array_equal(mine.index, ref.index)
    ident = dedup.identity_plan(msgs)
    assert ident.distinct == msgs and not ident.enabled
    np.testing.assert_array_equal(ident.index, np.arange(6))


def test_port_api_round_trips_and_rejects():
    """The port's own API types: wire round trips, the infinity pubkey
    rejected, host rejects through the bound entry point."""
    sk = torch_api.SecretKey.from_int(7)
    pk = torch_api.PublicKey.from_bytes(sk.public_key().to_bytes())
    sig = torch_api.Signature.from_bytes(sk.sign(M0).to_bytes())
    assert pk.to_bytes() == PKS[0].to_bytes()
    assert sig.to_bytes() == SKS[0].sign(M0).to_bytes()
    s = torch_api.SignatureSet.single_pubkey(sig, pk, M0)
    assert torch_api.verify_signature_sets_python([s])
    with pytest.raises(torch_api.BlsError):
        torch_api.PublicKey.from_bytes(bytes([0xC0]) + bytes(47))
    assert not torch_api.verify_signature_sets([], device="cpu")
