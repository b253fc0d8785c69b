"""The port's bucketed MSM (``lighthouse_tpu_torch/ops/msm.py``) and the
full-order subgroup check K15 on the CPU, against the JAX package.

On CPU tensors the MSM wrappers run the plain versions of kernels K5-K7.
The host schedule must equal the JAX package's byte for byte; the MSM must
equal the oracle's sum_i r_i S_i and the scan (per-set scalar
multiplication, then the S-leaf tree) at canonical affine, edge cases
included; schedule overflow must leave the fused verify on the scan with
the same verdict; K15's plain version must give the oracle's verdicts and
those of the JAX package's Pallas kernel in interpret mode. Inputs come
from seeded numpy generators. The slow tier holds the plain MSM against
the JAX package's ``msm_g2`` in interpret mode.
The kernels themselves need the card: ``tests/test_torch_kernels.py``.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.api import verify_signature_sets_python
from lighthouse_tpu.crypto.bls.curve import (
    g2_generator,
    g2_infinity,
    g2_subgroup_check,
)
from lighthouse_tpu.crypto.bls.fields import Fq2
from lighthouse_tpu.crypto.bls.hash_to_curve import map_to_curve_g2
from lighthouse_tpu.ops import msm as jmsm
from lighthouse_tpu.ops import points as jpoints
from lighthouse_tpu_torch.ops import msm, points
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from lighthouse_tpu_torch.ops.points import FP2_OPS
from lighthouse_tpu_torch.torch_backend import TorchBackend
from tests.test_torch_backend import _case

G2 = g2_generator()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs thousands of tiny ops; intra-op threads
    only spin on them (and fight the other test workers for cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _scalars(seed, n):
    """n nonzero uniform 64-bit scalars, as the backend's CSPRNG gives."""
    r = np.frombuffer(np.random.default_rng(seed).bytes(8 * n), np.uint64).copy()
    r[r == 0] = 1
    return r


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _msm_affine(pts, r, skip=None):
    """The port's plain MSM of oracle points -> canonical affine limbs."""
    sx, sy, _ = _t(*points.g2_to_dev(pts))
    idx, valid = msm.build_schedule(r, msm.max_rounds(len(pts)), skip)
    acc = msm.msm_g2(sx, sy, *_t(idx, valid))
    return points.pt_to_affine(FP2_OPS, tuple(c[None] for c in acc))


def _oracle(pts, r, skip=None):
    acc = None
    for i, (p, k) in enumerate(zip(pts, r)):
        if skip is None or not skip[i]:
            term = p.mul(int(k))
            acc = term if acc is None else acc.add(term)
    return g2_infinity() if acc is None else acc


def _assert_point(aff, want):
    ex, ey, einf = jpoints.g2_to_dev([want])
    np.testing.assert_array_equal(aff[0].numpy(), ex)
    np.testing.assert_array_equal(aff[1].numpy(), ey)
    np.testing.assert_array_equal(aff[2].numpy(), einf)


# --------------------------------------------------------- the schedule


def test_max_rounds_matches_jax():
    assert [msm.max_rounds(n) for n in range(1, 4097)] == \
        [jmsm.max_rounds(n) for n in range(1, 4097)]
    assert (msm.max_rounds(128), msm.max_rounds(2048)) == (48, 208)


@pytest.mark.parametrize("skip", [False, True], ids=["all", "skip"])
@pytest.mark.parametrize("S", [2, 8, 128, 2048])
def test_build_schedule_matches_jax(S, skip):
    r = _scalars(S, S)
    mask = np.arange(S) >= (S * 3) // 4 if skip else None
    L = msm.max_rounds(S)
    got = msm.build_schedule(r, L, mask)
    want = jmsm.build_schedule(r, L, mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape == (L, msm.N_BUCKETS)
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("S", [8, 128])
def test_build_schedule_overflow_matches_jax(S):
    """Both refuse the depth one below the fullest bucket, at the same L."""
    r = _scalars(S + 100, S)
    need = int(msm.build_schedule(r, S)[1].sum(axis=0).max())
    assert msm.build_schedule(r, need - 1) is None
    assert jmsm.build_schedule(r, need - 1) is None
    got, want = msm.build_schedule(r, need), jmsm.build_schedule(r, need)
    assert all(g.tobytes() == w.tobytes() for g, w in zip(got, want))


# ------------------------------------------------------ the plain MSM

EDGE_R = np.array([
    0x1234567890ABCDE5, 0x0FEDCBA987654325,   # window 0: digit 5 twice
    0x1111111111111171, 0x2222222222222272,   # window 1: digit 7, S and -S
    0x3333333333333373, 0x4444444444444444,   # ... then a further addition
    0x5555555555555555, 0x6666666666666666,
], np.uint64)


def _edge_points():
    """Set 1 repeats set 0's point (its mixed addition doubles); set 3 is
    -(set 2), cancelling in window 1's bucket before set 4 adds to it."""
    pts = [G2.mul(3 + 7 * i) for i in range(8)]
    pts[1] = pts[0]
    pts[3] = pts[2].neg()
    return pts


@pytest.fixture(scope="module")
def random_batch():
    pts = [G2.mul(11 + 5 * i) for i in range(8)]
    r = _scalars(8, 8)
    return pts, r, _msm_affine(pts, r)


def test_msm_plain_matches_oracle(random_batch):
    pts, r, aff = random_batch
    _assert_point(aff, _oracle(pts, r))


def test_msm_plain_matches_plain_scan(random_batch):
    """The MSM and the scan (pt_scalar_mul_bits, then pt_tree_sum) give the
    same canonical affine point."""
    pts, r, aff = random_batch
    sx, sy, sinf = _t(*points.g2_to_dev(pts))
    bits = torch.from_numpy(points.scalars_to_bits([int(k) for k in r], 64))
    rsig = points.pt_scalar_mul_bits(FP2_OPS, (sx, sy), sinf, bits)
    scan = points.pt_tree_sum(FP2_OPS, rsig, len(pts))
    want = points.pt_to_affine(FP2_OPS, tuple(c[None] for c in scan))
    for a, b in zip(aff, want):
        assert torch.equal(a, b)


def test_msm_plain_edge_cases_match_oracle():
    """A duplicate in a bucket (the doubling case), S and -S cancelling to
    infinity and then a further addition, empty buckets, a skipped set."""
    pts, skip = _edge_points(), np.arange(8) == 7
    idx, valid = msm.build_schedule(EDGE_R, msm.max_rounds(8), skip)
    assert valid[:2, 4 * 16 + 0].all() and set(idx[:2, 4 * 16 + 0]) == {0, 1}
    assert valid[:3, 6 * 16 + 1].all() and list(idx[:3, 6 * 16 + 1]) == [2, 3, 4]
    assert (~valid.any(axis=0)).any()  # empty buckets
    sx, sy, _ = _t(*points.g2_to_dev(pts))
    B = msm.accumulate(sx, sy, *_t(idx, valid))
    assert bool(FP2_OPS.is_zero(B[2][6 * 16 + 1])) is False  # S4 after S2 - S2
    aff = points.pt_to_affine(FP2_OPS, tuple(
        c[None] for c in msm.msm_g2(sx, sy, *_t(idx, valid))))
    _assert_point(aff, _oracle(pts, EDGE_R, skip))


def test_msm_plain_every_set_skipped_is_infinity():
    pts = _edge_points()
    aff = _msm_affine(pts, EDGE_R, np.ones(8, bool))
    assert aff[2].tolist() == [True]
    _assert_point(aff, g2_infinity())


def test_msm_plain_pad_lanes_stay_at_infinity():
    """Lanes 240-255 (the bucket axis padded to 256) never take a point."""
    pts = _edge_points()
    idx, valid = msm.build_schedule(EDGE_R, 8)
    sx, sy, _ = _t(*points.g2_to_dev(pts))
    B = msm.accum_plain(sx, sy, *_t(idx, valid))
    assert all(c.shape == (256, 2, 48) for c in B)
    assert bool(FP2_OPS.is_zero(B[2][240:]).all())
    assert not bool(B[0][240:].any())  # the all-zero pad point, as gathered


# ------------------------------------------------------------ the backend


def test_msm_option_follows_the_fused_path():
    assert TorchBackend(device="cpu", fused=True).msm is True
    assert TorchBackend(device="cpu", fused=True, msm=False).msm is False
    assert TorchBackend(device="cpu").msm is False  # classic on the CPU
    with pytest.raises(ValueError, match="fused"):
        TorchBackend(device="cpu", fused=False, msm=True)


def test_schedule_overflow_takes_the_scan(monkeypatch):
    """With max_rounds forced to 0 every schedule overflows: the fused core
    runs K3 G2's plain version and the tree instead of the MSM, and the
    verdict is the oracle's."""
    calls = {"msm": 0, "scan": 0}
    msm_g2, scalar_mul_g2 = msm.msm_g2, tc.scalar_mul_g2

    def count(key, fn):
        def wrapped(*args):
            calls[key] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(msm, "max_rounds", lambda n: 0)
    monkeypatch.setattr(msm, "msm_g2", count("msm", msm_g2))
    monkeypatch.setattr(tc, "scalar_mul_g2", count("scan", scalar_mul_g2))
    sets = _case("valid")
    be = TorchBackend(device="cpu", fused=True)
    assert be.msm and be.verify_signature_sets(sets) is True
    assert verify_signature_sets_python(sets) is True
    assert calls == {"msm": 0, "scan": 1}
    assert "msm_schedule" in be.last_stage_seconds


# ------------------------------------------------------------------ K15


def test_subgroup_full_plain_matches_oracle():
    """K15's plain version: True on a G2 point and at infinity, False on a
    map_to_curve_g2 output outside G2; each the oracle's answer."""
    pts = [G2.mul(12345), map_to_curve_g2(Fq2(2, 1)), G2.mul(3)]
    x, y, inf = _t(*jpoints.g2_to_dev(pts))
    inf[2] = True
    got = tc.subgroup_check_g2(x, y, inf).tolist()
    assert got == [True, False, True]
    assert got[:2] == [g2_subgroup_check(p) for p in pts[:2]]


def test_subgroup_full_plain_matches_jax_kernel_interpret():
    """K15's plain version against the JAX package's subgroup_check_g2_t
    (its Pallas kernel in interpret mode, as tests/test_tkernel.py runs it)
    on the same four lanes: in G2, outside G2 (map_to_curve_g2 without
    cofactor clearing), at infinity (a real point's limbs under the flag),
    in G2."""
    import jax.numpy as jnp

    from lighthouse_tpu.ops import tkernel as tk
    from lighthouse_tpu.ops import tkernel_calls as jtc

    pts = [G2.mul(7), map_to_curve_g2(Fq2(5, 7)), G2.mul(2), G2.mul(99)]
    x, y, inf = jpoints.g2_to_dev(pts)
    inf[2] = True
    want = jtc.subgroup_check_g2_t(tk.batch_to_t(x), tk.batch_to_t(y),
                                   jnp.asarray(inf)[None, :].astype(jnp.int32))
    got = tc.subgroup_check_g2(*_t(x, y, inf))
    assert list(np.asarray(want)) == got.tolist() == [True, False, True, True]


# ------------------------------------------------------------- slow tier


@pytest.mark.slow
def test_msm_plain_matches_jax_msm_interpret():
    """The port's plain MSM against the JAX package's msm_g2 (interpret
    mode) on the same signatures and schedule: equal canonical affine."""
    import jax.numpy as jnp

    pts, skip = _edge_points(), np.arange(8) == 7
    sx, sy, _ = jpoints.g2_to_dev(pts)
    idx, valid = jmsm.build_schedule(EDGE_R, jmsm.max_rounds(8), skip)
    acc = jmsm.msm_g2(jnp.asarray(sx), jnp.asarray(sy), jnp.asarray(idx),
                      jnp.asarray(valid))
    jx, jy, jinf = jpoints.pt_to_affine(jpoints.FP2_OPS, tuple(c[None] for c in acc))
    mine = _msm_affine(pts, EDGE_R, skip)
    np.testing.assert_array_equal(np.asarray(jx), mine[0].numpy())
    np.testing.assert_array_equal(np.asarray(jy), mine[1].numpy())
    np.testing.assert_array_equal(np.asarray(jinf), mine[2].numpy())
