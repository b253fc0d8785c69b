"""The port's device hash-to-G2 on the CPU, against the JAX package.

On CPU tensors the hash kernels' wrappers (``ops/tkernel_htc.py``: K12, K13,
K14) run their plain versions. These tests hold the host step to the JAX
package's ``htc.hash_to_field_dev`` byte for byte, the hard-coded CUDA
constants to the port's Python constants, each stage and the whole map (the
resident and chained plain versions and the classic ``ops/htc.py``
pipeline) to the pure-Python oracle and the RFC 9380 J.10.1 vectors, and
``TorchBackend(device_htc=True)`` to the oracle's verdicts. The tolerance
is exact equality of canonical limbs, affine points and verdicts.

The slow tier compares with the JAX package's live pipelines:
``htc.hash_to_g2_batch`` (XLA on the CPU) and ``tkernel_htc.hash_to_g2_fused``
(Pallas in interpret mode), resident and chained. The kernels themselves
need the card: ``tests/test_torch_kernels.py``.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.api import verify_signature_sets_python
from lighthouse_tpu.crypto.bls.curve import g2_infinity
from lighthouse_tpu.crypto.bls.fields import Fq2
from lighthouse_tpu.crypto.bls.hash_to_curve import (
    hash_to_g2,
    map_to_curve_g2,
    sswu_map_fq2,
)
from lighthouse_tpu.ops import htc as jhtc
from lighthouse_tpu.ops import points as jpoints
from lighthouse_tpu_torch import torch_backend
from lighthouse_tpu_torch.crypto.bls.constants import P, SSWU_A2, SSWU_B2, SSWU_Z2
from lighthouse_tpu_torch.ops import field, htc, points, tower
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from lighthouse_tpu_torch.ops import tkernel_htc as th
from lighthouse_tpu_torch.torch_backend import TorchBackend
from tests.test_hash_to_curve import RFC_H2C_DST, RFC_J10_1
from tests.test_torch_backend import M0, M1, _case

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"
MSGS = [b"abc", b"lighthouse-torch"]
A, B, Z = Fq2(*SSWU_A2), Fq2(*SSWU_B2), Fq2(*SSWU_Z2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs thousands of tiny ops; intra-op threads
    only spin on them (and fight the other test workers for cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fq2_batch(elems):
    return torch.from_numpy(np.stack([tower.fq2_to_dev(e) for e in elems]))


def _fq2(a, i) -> Fq2:
    return Fq2(*tower.fp2_from_dev(np.asarray(a)[i]))


def _assert_affine_equal(got, want_points):
    """Canonical affine (x, y, inf) tensors equal the oracle's points."""
    ex, ey, einf = jpoints.g2_to_dev(want_points)
    np.testing.assert_array_equal(got[0].numpy(), ex)
    np.testing.assert_array_equal(got[1].numpy(), ey)
    np.testing.assert_array_equal(got[2].numpy(), einf)


# ------------------------------------------------------------ host step


@pytest.mark.parametrize("dst", [htc.DST, RFC_H2C_DST], ids=["default", "rfc"])
def test_hash_to_field_dev_matches_jax(dst):
    """A repeated message included: the intra-batch memo copies its row."""
    msgs = [b"", b"abc", b"abc", bytes(range(100))]
    got = htc.hash_to_field_dev(msgs, dst)
    want = jhtc.hash_to_field_dev(msgs, dst)
    assert got.dtype == want.dtype and got.shape == (4, 2, 2, 48)
    np.testing.assert_array_equal(got, want)


# --------------------------------------------- constants hard-coded in csrc


def _words(x: int, n: int = 12):
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(n)]


def _fp2_words(pair):
    return [w for i in range(2) for w in _words(field.limbs_to_int(pair[i]))]


def _table_words(table):
    return [w for pair in table for w in _fp2_words(pair)]


CONSTANTS = {
    "kSswuA": _fp2_words(htc.A_DEV),
    "kSswuB": _fp2_words(htc.B_DEV),
    "kSswuZ": _fp2_words(htc.Z_DEV),
    "kCZ": _fp2_words(htc.C_Z_DEV),
    "kSqrtCands": _table_words(htc.SQRT_CANDS_DEV),
    "kIsoXNum": _table_words(htc.ISO_XNUM),
    "kIsoXDen": _table_words(htc.ISO_XDEN),
    "kIsoYNum": _table_words(htc.ISO_YNUM),
    "kIsoYDen": _table_words(htc.ISO_YDEN),
    "kSqrtRatioE": _words(htc.SQRT_RATIO_E, 24),
}


@pytest.mark.parametrize("name", sorted(CONSTANTS))
def test_htc_header_constants_match_python(name):
    text = (CSRC / "htc.cuh").read_text()
    body = re.search(rf"\b{name}\[[^=]*=\s*\{{(.*?)\}};", text, re.S).group(1)
    assert [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)] == CONSTANTS[name]


def test_sqrt_ratio_exponent_matches_the_jax_table():
    top = int(re.search(r"kSqrtRatioTopBit = (\d+);",
                        (CSRC / "htc.cuh").read_text()).group(1))
    bits = htc.SQRT_RATIO_BITS
    np.testing.assert_array_equal(bits, jhtc.SQRT_RATIO_BITS)
    assert top == len(bits) - 1 == 757 and int(bits.sum()) == 366
    assert htc.SQRT_RATIO_E == (P * P - 9) // 16


# ---------------------------------------------------------------- stages


def test_sqrt_ratio_plain_contract():
    """(True, sqrt(u/v)) for a square ratio, (False, sqrt(Z u/v)) else
    (RFC 9380 F.2.1), against the oracle's field arithmetic; u = 0 gives
    (True, 0)."""
    rng = random.Random(0xC0FFEE)
    us = [Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(3)] + [Fq2.zero()]
    vs = [Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(4)]
    is_sq, root = htc.sqrt_ratio(_fq2_batch(us), _fq2_batch(vs))
    want_sq = [(u * v.inv()).sqrt() is not None for u, v in zip(us, vs)]
    assert is_sq.tolist() == want_sq
    assert True in want_sq[:3] and False in want_sq[:3]
    for i, (u, v) in enumerate(zip(us, vs)):
        r = _fq2(root, i)
        assert r * r == (u * v.inv() if want_sq[i] else Z * u * v.inv()), i
    assert _fq2(root, 3) == Fq2.zero()


def _gx1_is_square(u: Fq2) -> bool:
    """Whether SSWU takes its first branch for u (the oracle's x1, gx1)."""
    tv1 = (Z * u.square()).square() + Z * u.square()
    x1 = B * (Z * A).inv() if tv1.is_zero() else (-B) * A.inv() * (Fq2.one() + tv1.inv())
    return ((x1.square() + A) * x1 + B).sqrt() is not None


def test_sswu_plain_matches_oracle():
    """htc.sswu_fq2 (x = x_num / x_den, y) and the SSWU + isogeny body of
    K12/K13 (at affine) against the oracle, on lanes that cover both sgn0
    parities of u, both square branches and the exceptional u = 0."""
    rng = random.Random(0)
    us = [Fq2(rng.randrange(P), rng.randrange(P)) for _ in range(4)] + [Fq2.zero()]
    assert {int(u.sgn0()) for u in us[:4]} == {0, 1}
    assert {_gx1_is_square(u) for u in us[:4]} == {True, False}
    u = _fq2_batch(us)
    xn, xd, y = htc.sswu_fq2(u)
    for i, e in enumerate(us):
        ex, ey = sswu_map_fq2(e)
        assert _fq2(xn, i) * _fq2(xd, i).inv() == ex, f"lane {i} x"
        assert _fq2(y, i) == ey, f"lane {i} y"
    got = points.pt_to_affine(points.FP2_OPS, th.sswu_iso_plain(u))
    _assert_affine_equal(got, [map_to_curve_g2(e) for e in us])


# --------------------------------------------------------- the whole map


def test_resident_plain_matches_oracle_and_rfc_vector():
    """K12's plain version on two messages under the default DST and one
    RFC 9380 J.10.1 message under its DST, finished by K2's plain version."""
    rfc_msg = b"abc"
    us = torch.from_numpy(np.concatenate([
        htc.hash_to_field_dev(MSGS), htc.hash_to_field_dev([rfc_msg], RFC_H2C_DST)]))
    x, y, inf = tc.to_affine_g2(th.map_to_g2_resident(us))
    _assert_affine_equal((x[:2], y[:2], inf[:2]), [hash_to_g2(m) for m in MSGS])
    (ex0, ex1), (ey0, ey1) = RFC_J10_1[rfc_msg]
    assert not bool(inf[2])
    assert _fq2(x, 2) == Fq2(ex0, ex1) and _fq2(y, 2) == Fq2(ey0, ey1)


@pytest.mark.parametrize("pipeline", ["chained", "classic"])
def test_pipeline_plain_matches_oracle(pipeline):
    """The chained route (K13's plain version, the add, K14's) and the
    classic ops/htc.py pipeline: the oracle's hash_to_g2 points."""
    if pipeline == "chained":
        got = th.hash_to_g2_fused_dev(MSGS, device="cpu", resident=False)
    else:
        got = htc.hash_to_g2_batch(MSGS)
    _assert_affine_equal(got, [hash_to_g2(m) for m in MSGS])


# ------------------------------------------------------- the backend


@pytest.mark.parametrize("name, want", [("valid", True), ("wrong_message", False)])
def test_device_htc_backend_matches_oracle(monkeypatch, name, want):
    """The fused path with the device hash gives the oracle's verdicts and
    never calls the host oracle's hash."""
    def no_host_hash(*_):
        raise AssertionError("the device route called the host oracle")

    sets = _case(name)
    assert verify_signature_sets_python(sets) is want
    monkeypatch.setattr(torch_backend, "hash_to_g2", no_host_hash)
    be = TorchBackend(device="cpu", fused=True, device_htc=True)
    assert be.device_htc and be.htc_resident
    assert be.verify_signature_sets(sets) is want
    assert {"htc_dedup", "htc_map", "htc_cofactor"} <= set(be.last_stage_seconds)


def test_device_hash_branch_matches_oracle_branch():
    """Both routes of _hash_messages on 3 rows with a duplicate (S = 4):
    equal limbs row for row, the padding row at infinity."""
    msgs, S, inf2 = [M0, M1, M0], 4, g2_infinity()
    dev = TorchBackend(device="cpu", device_htc=True, htc_resident=False)
    host = TorchBackend(device="cpu")
    assert not host.device_htc
    gx, gy, ginf = dev._hash_messages(msgs, S, inf2, {})
    hx, hy, hinf = host._hash_messages(msgs, S, inf2, {})
    np.testing.assert_array_equal(ginf.numpy(), hinf)
    assert ginf.tolist() == [False, False, False, True]
    np.testing.assert_array_equal(gx[:3].numpy(), hx[:3])
    np.testing.assert_array_equal(gy[:3].numpy(), hy[:3])


def test_device_hash_defaults_to_the_card():
    """No device means the card: without CUDA hash_to_g2_fused_dev raises instead of
    running on the host; the backend hashes on the card only by default."""
    assert TorchBackend(device="cpu", fused=True).device_htc is False
    if torch.cuda.is_available():
        assert TorchBackend().device_htc is True
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            th.hash_to_g2_fused_dev(MSGS)


# ----------------------------------------------------------------- slow tier
# The JAX package's live pipelines (XLA on the CPU; Pallas in interpret
# mode), minutes to trace, against the port's plain versions.

SLOW_MSGS = [b"", b"abc", bytes(range(32)), b"fused-vs-classic"]


def _port_pipeline(kind, msgs, dst=htc.DST):
    if kind == "classic":
        return htc.hash_to_g2_batch(msgs, dst)
    return th.hash_to_g2_fused_dev(msgs, dst, device="cpu",
                                   resident=kind == "resident")


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["resident", "chained", "classic"])
def test_port_matches_jax_hash_to_g2_batch(kind):
    x, y, inf = (np.asarray(v) for v in jhtc.hash_to_g2_batch(SLOW_MSGS))
    gx, gy, ginf = _port_pipeline(kind, SLOW_MSGS)
    np.testing.assert_array_equal(gx.numpy(), x)
    np.testing.assert_array_equal(gy.numpy(), y)
    np.testing.assert_array_equal(ginf.numpy(), inf)


@pytest.mark.slow
@pytest.mark.parametrize("resident", ["1", "0"])
def test_port_matches_jax_fused_pallas(monkeypatch, resident):
    from lighthouse_tpu.ops.tkernel_htc import hash_to_g2_fused

    monkeypatch.setenv("LHTPU_HTC_RESIDENT", resident)
    x, y, inf = hash_to_g2_fused(SLOW_MSGS)
    gx, gy, ginf = _port_pipeline("resident" if resident == "1" else "chained",
                                  SLOW_MSGS)
    np.testing.assert_array_equal(gx.numpy(), x)
    np.testing.assert_array_equal(gy.numpy(), y)
    np.testing.assert_array_equal(ginf.numpy(), inf)


@pytest.mark.slow
@pytest.mark.parametrize("kind", ["resident", "chained", "classic"])
def test_port_rfc_j10_1(kind):
    msgs = list(RFC_J10_1)
    x, y, inf = _port_pipeline(kind, msgs, RFC_H2C_DST)
    assert not inf.any()
    for i, m in enumerate(msgs):
        (ex0, ex1), (ey0, ey1) = RFC_J10_1[m]
        assert _fq2(x, i) == Fq2(ex0, ex1) and _fq2(y, i) == Fq2(ey0, ey1)
