"""The port's Fp layer and kernel K1's plain version against the JAX
package's ``ops/limb.py`` and the big-int oracle.

Tolerance: exact equality of the int32 limb arrays. The port follows the
reference's reduction schedule, so its limbs must be bit-identical, not
merely equal after ``canonical``. Inputs come from a seeded numpy generator
(plus the edge rows 0, 1, p-1, p, 2p-1 and R mod p).
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu.ops import limb
from lighthouse_tpu.ops import points as jpoints
from lighthouse_tpu.crypto.bls.api import SecretKey as JaxSecretKey
from lighthouse_tpu_torch import interop
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import _build, field, mont_mul, points

R = 1 << 384
EDGES = [0, 1, P - 1, P, 2 * P - 1, R % P]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs thousands of tiny ops; intra-op threads
    only spin on them (and fight the other test workers for cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rand_almost(rng, n):
    """n values in [0, 2p) from 48 random bytes each, reduced."""
    raw = rng.integers(0, 256, size=(n, 48), dtype=np.uint8)
    return [int.from_bytes(r.tobytes(), "little") % (2 * P) for r in raw]


def _operands(seed, n=58):
    """a, b: int32 [n + 36, 48]: random rows, then every edge-row pair."""
    rng = np.random.default_rng(seed)
    a = _rand_almost(rng, n) + [x for x in EDGES for _ in EDGES]
    b = _rand_almost(rng, n) + [y for _ in EDGES for y in EDGES]
    return limb.ints_to_limbs(a), limb.ints_to_limbs(b), a, b


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _ints(arr):
    return [limb.limbs_to_int(r) for r in np.asarray(arr)]


def test_mont_mul_plain_matches_reference_and_bigint():
    a, b, ai, bi = _operands(1)
    got = mont_mul.mont_mul_plain(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(got, np.asarray(limb.mont_mul(a, b)))
    ninv = pow(P, -1, R)
    for x, y, z in zip(ai, bi, _ints(got)):
        t = x * y
        assert z == (t + ((-t * ninv) % R) * P) // R  # exact REDC integer


def test_mont_mul_broadcasts_like_reference():
    a, b, _, _ = _operands(2, n=12)
    a3 = a[:48].reshape(2, 4, 6, 48)
    got = field.mont_mul(_t(a3), _t(b[0]))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(limb.mont_mul(a3, b[0]))
    )


@pytest.mark.parametrize("name", ["add", "sub", "double"])
def test_binary_ops_match_reference(name):
    a, b, _, _ = _operands(3)
    args = (a, b) if name != "double" else (a,)
    got = getattr(field, name)(*map(_t, args)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(limb, name)(*args)))


@pytest.mark.parametrize("name", ["neg", "canonical", "sgn0", "is_zero"])
def test_unary_ops_match_reference(name):
    a, _, _, _ = _operands(4)
    got = getattr(field, name)(_t(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(getattr(limb, name)(a)))


def test_eq_matches_reference():
    a, b, ai, _ = _operands(5)
    shifted = limb.ints_to_limbs([(x + P) % (2 * P) for x in ai])
    for other in (b, shifted):
        np.testing.assert_array_equal(
            field.eq(_t(a), _t(other)).numpy(), np.asarray(limb.eq(a, other))
        )


def test_add_sub_fused_matches_separate_calls():
    a, b, _, _ = _operands(6)
    s, d = field.add_sub(_t(a), _t(b))
    np.testing.assert_array_equal(s.numpy(), np.asarray(limb.add(a, b)))
    np.testing.assert_array_equal(d.numpy(), np.asarray(limb.sub(a, b)))


def test_mont_inv_matches_reference():
    a, _, ai, _ = _operands(7, n=3)
    a = a[:4]
    got = field.mont_inv(_t(a)).numpy()
    np.testing.assert_array_equal(got, np.asarray(limb.mont_inv(a)))
    for x, z in zip(ai[:4], _ints(got)):
        if x % P:
            assert (x * z) % P == (R * R) % P  # Montgomery inverse


def test_to_from_mont_roundtrip():
    rng = np.random.default_rng(8)
    xs = [x % P for x in _rand_almost(rng, 16)]
    m = field.to_mont(_t(limb.ints_to_limbs(xs)))
    np.testing.assert_array_equal(m.numpy(), limb.ints_to_limbs_mont(xs))
    assert _ints(field.from_mont(m).numpy()) == xs


def test_host_packing_byte_equal_to_reference():
    rng = np.random.default_rng(9)
    xs = [x % P for x in _rand_almost(rng, 64)] + [0, 1, P - 1]
    np.testing.assert_array_equal(
        field.ints_to_limbs_mont(xs), limb.ints_to_limbs_mont(xs)
    )
    sks = [JaxSecretKey.from_int(k) for k in (3, 5)]
    g1 = [sk.public_key().point for sk in sks]
    g2 = [sk.sign(b"\x33" * 32).point for sk in sks]
    for mine, ref in ((points.g1_to_dev(g1), jpoints.g1_to_dev(g1)),
                      (points.g2_to_dev(g2), jpoints.g2_to_dev(g2))):
        for m, r in zip(mine, ref):
            assert m.dtype == r.dtype and m.shape == r.shape
            np.testing.assert_array_equal(m, r)
    # and back to affine points, from numpy arrays or tensors
    back1 = points.g1_from_dev(*map(_t, points.g1_to_dev(g1)))
    back2 = points.g2_from_dev(*points.g2_to_dev(g2))
    assert [(p.x.n, p.y.n) for p in back1] == [(p.x.n, p.y.n) for p in g1]
    assert [(p.x.c0, p.x.c1, p.y.c0, p.y.c1) for p in back2] == [
        (p.x.c0, p.x.c1, p.y.c0, p.y.c1) for p in g2]


def test_word_repack_roundtrip():
    a, _, ai, _ = _operands(10)
    words = interop.limbs_to_words(_t(a))
    assert words.shape == (a.shape[0], 12)
    for x, w in zip(ai, words.tolist()):
        assert sum(v << (32 * k) for k, v in enumerate(w)) == x
    np.testing.assert_array_equal(interop.words_to_limbs(words).numpy(), a)


def test_import_builds_nothing_and_cpu_stays_plain():
    """Importing the kernel module builds and loads nothing; a CPU tensor
    never reaches the kernel; a CPU tensor handed to the kernel wrapper
    raises instead of falling back."""
    assert mont_mul._FN is None and mont_mul._LIB._lib is None
    assert mont_mul.K1 in _build.KERNELS
    before = mont_mul.K1.launches
    a, b, _, _ = _operands(11, n=2)
    field.mont_mul(_t(a), _t(b))
    assert mont_mul.K1.launches == before and mont_mul._LIB._lib is None
    with pytest.raises(ValueError, match="CUDA"):
        mont_mul.mont_mul_cuda(_t(a), _t(b))


@pytest.mark.slow
def test_plain_matches_pallas_kernel_interpret():
    """The plain version against the Pallas K1 itself (interpret mode)."""
    from lighthouse_tpu.ops.pallas_mont import mont_mul_pallas

    a, b, _, _ = _operands(13, n=20)
    np.testing.assert_array_equal(
        mont_mul.mont_mul_plain(_t(a), _t(b)).numpy(),
        np.asarray(mont_mul_pallas(a, b)),
    )
