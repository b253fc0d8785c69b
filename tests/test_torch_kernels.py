"""The port's CUDA kernels (K1, the fused verify kernels, the MSM kernels,
the full-order subgroup check and the hash kernels) against their plain
PyTorch versions.

Imports only torch, numpy and the port, so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

The ``cuda`` tests skip without a card (a CUDA kernel has no CPU mode);
the wrapper's input checks and the constants hard-coded in the new
sources run everywhere.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import horner_edge_windows, tree_edge_buckets
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.constants import R as ORDER
from lighthouse_tpu_torch.crypto.bls.curve import g1_generator, g2_generator, g2_infinity
from lighthouse_tpu_torch.crypto.bls.fields import Fq2
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2, map_to_curve_g2
from lighthouse_tpu_torch.ops import coop, field, htc, mont_mul, msm, pairing, points, tower
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from lighthouse_tpu_torch.ops import tkernel_htc as th

R = 1 << 384
EDGES = [0, 1, P - 1, P, 2 * P - 1, R % P]


def _operands(seed, n):
    """int32 [n + 36, 48] pairs: random rows in [0, 2p), then every pair of
    edge rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n + 36, 48), dtype=np.int32)
    b = rng.integers(0, 256, size=(n + 36, 48), dtype=np.int32)
    a[:, 47] %= 0x34  # below 2p (whose top byte is 0x34)
    b[:, 47] %= 0x34
    a[n:] = field.ints_to_limbs([x for x in EDGES for _ in EDGES])
    b[n:] = field.ints_to_limbs([y for _ in EDGES for y in EDGES])
    return torch.from_numpy(a), torch.from_numpy(b)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


@pytest.mark.parametrize("bad, err", [
    (lambda a: a.to(torch.int64), TypeError),
    (lambda a: a[..., :47], ValueError),
    (lambda a: a, ValueError),  # a CPU tensor never reaches the kernel
])
def test_kernel_wrapper_rejects(bad, err):
    a, b = _operands(1, 4)
    with pytest.raises(err):
        mont_mul.mont_mul_cuda(bad(a), b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4000,), (3, 5, 7), (0,), (1,), (54,), (63,),
                                   (65,), (4097,), (70_001,)])
def test_kernel_matches_plain_and_bigint(shape):
    """K1 against the plain version and Python integers; K1's tiles are 64
    products, so sizes off the tile (and a tile walk past several) copy,
    compute and store only their rows."""
    _card()
    n = int(np.prod(shape))
    a, b = _operands(2, n)
    a, b = a[:n].reshape(*shape, 48).cuda(), b[:n].reshape(*shape, 48).cuda()
    before = mont_mul.K1.launches
    got = mont_mul.mont_mul_cuda(a, b)
    torch.cuda.synchronize()
    assert got.shape == (*shape, 48) and got.dtype == torch.int32
    assert mont_mul.K1.launches == before + (1 if n else 0)
    assert torch.equal(got, mont_mul.mont_mul_plain(a, b))
    ninv = pow(P, -1, R)
    for x, y, z in zip(a.reshape(-1, 48)[:64].cpu().numpy(),
                       b.reshape(-1, 48)[:64].cpu().numpy(),
                       got.reshape(-1, 48)[:64].cpu().numpy()):
        t = field.limbs_to_int(x) * field.limbs_to_int(y)
        assert field.limbs_to_int(z) == (t + ((-t * ninv) % R) * P) // R


@pytest.mark.cuda
def test_kernel_edges_and_broadcast():
    _card()
    a, b = _operands(3, 0)
    a, b = a.cuda(), b.cuda()
    assert torch.equal(mont_mul.mont_mul_cuda(a, b), mont_mul.mont_mul_plain(a, b))
    # a broadcast constant operand and an offset (non-16-byte-aligned) view
    k = b[7]
    assert torch.equal(mont_mul.mont_mul_cuda(a, k), mont_mul.mont_mul_plain(a, k))
    buf = torch.zeros(1 + 48 * 5, dtype=torch.int32, device=a.device)
    buf[1:] = a[:5].reshape(-1)
    odd = buf[1:].view(5, 48)
    assert odd.data_ptr() % 16
    assert torch.equal(mont_mul.mont_mul_cuda(odd, b[:5]),
                       mont_mul.mont_mul_plain(odd, b[:5]))
    # operands of different shapes, broadcast by the wrapper
    a, b = _operands(5, 400)
    for sa, sb in (((300, 48), (48,)), ((2, 1, 48), (77, 48)), ((1, 48), (333, 48))):
        x = a.reshape(-1)[:int(np.prod(sa))].reshape(sa).cuda()
        y = b.reshape(-1)[:int(np.prod(sb))].reshape(sb).cuda()
        assert torch.equal(mont_mul.mont_mul_cuda(x, y), mont_mul.mont_mul_plain(x, y))


@pytest.mark.parametrize("sa, sb", [
    ((5, 48), (48,)), ((2, 1, 48), (77, 48)), ((1, 48), (333, 48)),
    ((3, 5, 7, 48), (5, 1, 48)), ((4, 48), (4, 48)),
])
def test_broadcast_by_shape_arithmetic_matches_torch(sa, sb):
    """The wrapper's broadcast (shape arithmetic, taken only when the
    shapes differ) gives torch's shape; incompatible shapes raise."""
    a, b = torch.zeros(sa, dtype=torch.int32), torch.zeros(sb, dtype=torch.int32)
    x, y = mont_mul._broadcast(a, b)
    assert x.shape == y.shape == torch.broadcast_shapes(a.shape, b.shape)
    with pytest.raises(ValueError):
        mont_mul._broadcast(torch.zeros((5, 48), dtype=torch.int32),
                            torch.zeros((3, 6, 48), dtype=torch.int32))


def test_aligned_operand_is_used_as_it_is():
    """A contiguous 16-byte aligned operand (the verify path's every one)
    reaches the kernel uncopied; an offset or strided one is copied into
    an aligned contiguous tensor."""
    a = torch.zeros(8, 48, dtype=torch.int32)
    assert mont_mul._aligned(a) is a
    buf = torch.zeros(1 + 48 * 5, dtype=torch.int32)
    odd = buf[1:].view(5, 48)
    got = mont_mul._aligned(odd)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert torch.equal(got, odd)
    t = mont_mul._aligned(a.t().contiguous().t())
    assert t.is_contiguous() and torch.equal(t, a)


# ------------------------------------------------------ the fused kernels
# Each fused kernel (ops/tkernel_calls.py) against its plain version on the
# same CUDA tensors, at small shapes with the edge lanes of the verify path:
# infinity, Z = 1, scalars 0, 1, 2^64 - 1 and a single one bit, points outside
# G2. Raw limbs must be equal (the CUDA tower follows ops/tower.py op for op),
# which implies equality after canonical.

SCALARS = [0, 1, (1 << 64) - 1, 0x9E3779B97F4A7C15]


def _cuda(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in arrays)


def _group(name):
    if name == "g1":
        return g1_generator(), points.FP_OPS, points.g1_to_dev, tc.K3_G1
    return g2_generator(), points.FP2_OPS, points.g2_to_dev, tc.K3_G2


def _same(got, want):
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


def _same_canonical(got, want):
    """Equal after canonical: K9's divstep inversion may leave another
    representative in [0, 2p) than its plain version's Fermat."""
    return _same(field.canonical(got), field.canonical(want))


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_and_to_affine_kernels_match_plain(group):
    _card()
    gen, F, pack, k3 = _group(group)
    x, y, inf = _cuda(*pack([gen.mul(k) for k in (2, 3, 5, 7, 11, 13, 17)]))
    inf[4] = inf[6] = True  # bases at infinity, under 5 and 2^64 - 1
    bits = _cuda(points.scalars_to_bits(SCALARS + [5, 1 << 40, (1 << 64) - 1], 64))[0]
    mul = tc.scalar_mul_g1 if group == "g1" else tc.scalar_mul_g2
    before = k3.launches
    J = mul(x, y, inf, bits)
    assert k3.launches == before + 1
    assert _same(J, points.pt_scalar_mul_bits(F, (x, y), inf, bits))
    one = points.pt_from_affine(F, x[1:2], y[1:2])  # lane 1 at Z = 1
    J = tuple(torch.cat([c[:1], o, c[2:]]) for o, c in zip(one, J))
    aff = tc.to_affine_g1 if group == "g1" else tc.to_affine_g2
    got = aff(J)
    assert _same(got, points.pt_to_affine(F, J))
    assert got[2].tolist() == [True, False, False, False, True, False, True]  # [0]Q, inf


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_kernel_packs_lanes_past_the_sms(group):
    """K3 on more lanes than the card has SMs, where its launch packs
    several lanes into a warp: raw limbs of pt_scalar_mul_bits on seeded
    scalars with the edge lanes among them, and a ragged last warp."""
    _card()
    gen, F, pack, k3 = _group(group)
    n = torch.cuda.get_device_properties(0).multi_processor_count + 3
    x, y, inf = _cuda(*pack([gen.mul(k) for k in range(2, 9)]))
    rows = torch.arange(n, device="cuda") % 7
    x, y, inf = x[rows], y[rows], inf[rows]
    inf[5] = True  # a base at infinity under 2^64 - 1
    rng = np.random.default_rng(11)
    scal = [int(k) for k in rng.integers(0, 1 << 64, n, dtype=np.uint64)]
    scal[:8] = SCALARS + [5, 1 << 40, (1 << 64) - 1, 1 << 63]
    bits = _cuda(points.scalars_to_bits(scal, 64))[0]
    mul = tc.scalar_mul_g1 if group == "g1" else tc.scalar_mul_g2
    before = k3.launches
    J = mul(x, y, inf, bits)
    assert k3.launches == before + 1
    assert _same(J, points.pt_scalar_mul_bits(F, (x, y), inf, bits))


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_kernel_edge_lanes(group):
    """K2 (the divstep inversion) raw-equal to pt_to_affine (Fermat) with
    Z = 0, Z = p (the lazy zero), Z = Montgomery one, Z in [p, 2p) and
    Z = p - 1 in Montgomery form; the first two are infinity."""
    _card()
    gen, F, pack, _ = _group(group)
    x, y, _ = pack([gen.mul(k) for k in (2, 3, 5, 7, 11)])
    zs = field.ints_to_limbs([0, P, R % P, P + 12345, (P - 1) * R % P])
    z = zs if group == "g1" else np.stack([zs, np.zeros_like(zs)], axis=1)
    J = _cuda(x, y, z)
    aff = tc.to_affine_g1 if group == "g1" else tc.to_affine_g2
    got = aff(J)
    assert _same(got, points.pt_to_affine(F, J))
    assert got[2].tolist() == [True, True, False, False, False]


@pytest.mark.cuda
def test_subgroup_fast_kernel_matches_plain_and_full_order():
    _card()
    g = g2_generator()
    pts = [g.mul(3), map_to_curve_g2(Fq2(2, 1)), g.mul(12345),
           map_to_curve_g2(Fq2(5, 7)), g.mul(9)]
    x, y, inf = _cuda(*points.g2_to_dev(pts))
    inf[4] = True
    got = tc.subgroup_check_g2_fast(x, y, inf)
    assert _same(got, points.subgroup_check_g2_fast(x, y, inf))
    full = points.pt_subgroup_check(points.FP2_OPS,
                                    points.pt_from_affine(points.FP2_OPS, x, y, inf))
    assert got.tolist() == full.tolist() == [True, False, True, False, True]


@pytest.mark.cuda
def test_subgroup_fast_kernel_in_every_shape():
    """K4 one warp per lane, 4 lanes per warp and one thread per lane
    (lh_subgroup_fast_shaped) on more lanes than the card has SMs, a
    ragged last warp among them: each shape's verdicts are the plain
    version's; the wrapper's launch takes the shape lh_subgroup_fast
    chooses, and counts one launch."""
    import ctypes

    _card()
    g = g2_generator()
    pts = [g.mul(k) for k in range(2, 7)] + [map_to_curve_g2(Fq2(k, 1)) for k in range(2)]
    n = torch.cuda.get_device_properties(0).multi_processor_count + 3
    x, y, inf = _cuda(*points.g2_to_dev(pts))
    rows = torch.arange(n, device="cuda") % len(pts)
    x, y, inf = x[rows], y[rows], inf[rows]
    inf[3] = True
    want = points.subgroup_check_g2_fast(x, y, inf)
    lib = tc.K4.library.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for lanes in (1, 4, 32):
        out = torch.empty(n, dtype=torch.bool, device="cuda")
        rc = lib.lh_subgroup_fast_shaped(
            *(ctypes.c_void_p(t.data_ptr()) for t in (x, y, inf, out)),
            ctypes.c_int(lanes), ctypes.c_longlong(n), stream)
        assert rc == 0
        assert _same(out, want), lanes
    before = tc.K4.launches
    assert _same(tc.subgroup_check_g2_fast(x, y, inf), want)
    assert tc.K4.launches == before + 1


@pytest.mark.cuda
def test_subgroup_full_kernel_in_every_shape():
    """K15 one warp per lane, 4 lanes per warp and one thread per lane
    (lh_subgroup_full_shaped, the NAF chain) on more lanes than the card
    has SMs, a ragged last warp among them: each shape's verdicts are its
    plain version's and K4's; the wrapper takes the shape its rule chooses
    and counts one launch."""
    import ctypes

    _card()
    g = g2_generator()
    pts = [g.mul(k) for k in range(2, 7)] + [map_to_curve_g2(Fq2(k, 1)) for k in range(2)]
    n = torch.cuda.get_device_properties(0).multi_processor_count + 3
    x, y, inf = _cuda(*points.g2_to_dev(pts))
    rows = torch.arange(n, device="cuda") % len(pts)
    x, y, inf = x[rows], y[rows], inf[rows]
    inf[3] = inf[5] = True
    F = points.FP2_OPS
    want = points.pt_subgroup_check(F, points.pt_from_affine(F, x, y, inf))
    assert _same(want, points.subgroup_check_g2_fast(x, y, inf))
    assert not bool(want.all()) and bool(want[inf].all())
    lib = tc.K15.library.load()
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    for lanes in (1, 4, 32):
        out = torch.empty(n, dtype=torch.bool, device="cuda")
        rc = lib.lh_subgroup_full_shaped(
            *(ctypes.c_void_p(t.data_ptr()) for t in (x, y, inf, out)),
            ctypes.c_int(lanes), ctypes.c_longlong(n), stream)
        assert rc == 0
        assert _same(out, want), lanes
    before = tc.K15.launches
    assert _same(tc.subgroup_check_g2(x, y, inf), want)
    assert tc.K15.launches == before + 1


@pytest.mark.cuda
def test_miller_and_final_exp_kernels_match_plain():
    _card()
    g1, g2 = g1_generator(), g2_generator()
    px, py, pinf = _cuda(*points.g1_to_dev([g1.mul(k) for k in (3, 4, 5)]))
    qx, qy, qinf = _cuda(*points.g2_to_dev([g2.mul(k) for k in (6, 7, 8)]))
    pinf[1] = True
    qinf[2] = True
    f = tc.miller_loop((px, py), pinf, (qx, qy), qinf)
    assert _same(f, tc.miller_loop_seg((px, py), pinf, (qx, qy), qinf))
    g = tc.easy_exp(f)
    assert _same(g, coop.easy_exp_steps(f))  # its plan, limb for limb
    assert _same_canonical(g, tc.easy_exp_plain(f))
    for xm1 in (False, True):
        assert _same(tc.pow_x(g, xm1), tc.pow_x_plain(g, xm1))
    for mode in tc.COMB_MODES:
        assert _same(tc.comb(f, g, mode), tc.comb_plain(f, g, mode))
    assert _same_canonical(tc.final_exp_kernel(f[:1]), pairing.final_exponentiation(f[:1]))


def _miller_inputs(n):
    """n (P, Q) lanes on the card: P = [k + 2]G1, Q = [k + 5]G2."""
    g1, g2 = g1_generator(), g2_generator()
    px, py, pinf = _cuda(*points.g1_to_dev([g1.mul(k + 2) for k in range(n)]))
    qx, qy, qinf = _cuda(*points.g2_to_dev([g2.mul(k + 5) for k in range(n)]))
    return (px, py), pinf, (qx, qy), qinf


@pytest.mark.cuda
def test_miller_kernel_matches_plain_at_path_width():
    """K8, one block per lane, at the verify's 129 lanes: raw limbs, with
    P, Q and both at infinity on three lanes (Fp12 one there)."""
    _card()
    p, pinf, q, qinf = _miller_inputs(129)
    pinf[3] = qinf[125] = True
    pinf[64] = qinf[64] = True
    before = tc.K8.launches
    f = tc.miller_loop(p, pinf, q, qinf)
    assert tc.K8.launches == before + 1
    assert _same(f, tc.miller_loop_seg(p, pinf, q, qinf))
    one = torch.from_numpy(tower.FP12_ONE).cuda()
    assert all(torch.equal(f[i], one) for i in (3, 64, 125))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 2, 33])
def test_pow_x_kernel_matches_plain_on_cyclotomic_lanes(n):
    """K10, one block per lane, on K9's outputs (cyclotomic), x and xm1."""
    _card()
    g = tc.easy_exp(tc.miller_loop(*_miller_inputs(n)))
    for xm1 in (False, True):
        before = tc.K10.launches
        got = tc.pow_x(g, xm1)
        assert tc.K10.launches == before + 1
        assert _same(got, tc.pow_x_plain(g, xm1))


@pytest.mark.cuda
def test_final_exp_chain_matches_final_exponentiation():
    """The 9-launch chain (K9, K10 five times, K11 three times) on two lanes
    against the classic final exponentiation, after canonical (K9's
    divstep inversion), with the same fp12_is_one."""
    _card()
    f = tc.miller_loop(*_miller_inputs(2))
    before = tc.K10.launches
    got = tc.final_exp_kernel(f)
    assert tc.K10.launches == before + 5
    want = pairing.final_exponentiation(f)
    assert _same_canonical(got, want)
    assert torch.equal(tower.fp12_is_one(got), tower.fp12_is_one(want))


@pytest.mark.cuda
def test_fused_kernels_launch_nothing_on_zero_lanes():
    _card()
    e1 = torch.empty(0, 48, dtype=torch.int32, device="cuda")
    e2 = torch.empty(0, 2, 48, dtype=torch.int32, device="cuda")
    m = torch.empty(0, dtype=torch.bool, device="cuda")
    f = torch.empty(0, 2, 3, 2, 48, dtype=torch.int32, device="cuda")
    b = torch.empty(0, 64, dtype=torch.int32, device="cuda")
    before = {k.name: k.launches for k in tc._build.KERNELS}
    assert tc.to_affine_g2((e2, e2, e2))[0].shape == (0, 2, 48)
    assert tc.scalar_mul_g1(e1, e1, m, b)[2].shape == (0, 48)
    assert tc.subgroup_check_g2_fast(e2, e2, m).shape == (0,)
    assert tc.subgroup_check_g2(e2, e2, m).shape == (0,)
    assert tc.miller_loop((e1, e1), m, (e2, e2), m).shape == (0, 2, 3, 2, 48)
    assert tc.comb(f, f, "b").shape == (0, 2, 3, 2, 48)
    us = torch.empty(0, 2, 2, 48, dtype=torch.int32, device="cuda")
    assert th.map_to_g2_resident(us)[0].shape == (0, 2, 48)
    assert th.sswu_iso(e2)[2].shape == (0, 2, 48)
    assert th.clear_cofactor((e2, e2, e2))[1].shape == (0, 2, 48)
    assert {k.name: k.launches for k in tc._build.KERNELS} == before


@pytest.mark.cuda
def test_subgroup_full_kernel_matches_plain_and_fast():
    """K15 against its plain version and against K4 on points in and out
    of G2 and a lane at infinity."""
    _card()
    g = g2_generator()
    pts = [g.mul(3), map_to_curve_g2(Fq2(2, 1)), g.mul(12345),
           map_to_curve_g2(Fq2(5, 7)), g.mul(9)]
    x, y, inf = _cuda(*points.g2_to_dev(pts))
    inf[4] = True
    before = tc.K15.launches
    got = tc.subgroup_check_g2(x, y, inf)
    assert tc.K15.launches == before + 1
    plain = points.pt_subgroup_check(points.FP2_OPS,
                                     points.pt_from_affine(points.FP2_OPS, x, y, inf))
    assert _same(got, plain)
    assert got.tolist() == tc.subgroup_check_g2_fast(x, y, inf).tolist() == \
        [True, False, True, False, True]


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 8])
def test_comb_kernel_matches_plan_and_plain(lanes):
    """K11, one block per lane on its mode's plan, raw-equal to the plan's
    model and to comb_plain in each mode, counted once per launch."""
    _card()
    g1, g2 = g1_generator(), g2_generator()
    px, py, pinf = _cuda(*points.g1_to_dev([g1.mul(k + 3) for k in range(lanes)]))
    qx, qy, qinf = _cuda(*points.g2_to_dev([g2.mul(k + 6) for k in range(lanes)]))
    f = tc.miller_loop_seg((px, py), pinf, (qx, qy), qinf)
    g = tc.easy_exp_plain(f)
    for mode in tc.COMB_MODES:
        before = tc.K11.launches
        got = tc.comb(f, g, mode)
        assert tc.K11.launches == before + 1
        assert _same(got, coop.comb_steps(f, g, mode))
        assert _same(got, tc.comb_plain(f, g, mode))


# ------------------------------------------------------- the MSM kernels
# K5 (accumulate), K6 (tree) and K7 (Horner) against their plain versions on
# 8 sets with the edge cases: a duplicate signature whose mixed addition
# doubles, S and -S cancelling in a bucket before a further addition, empty
# buckets, a skipped set; and with every set skipped. K5 raw against its
# segment model at the launch's segments (accum_plain itself unsplit) and
# against accum_plain at canonical affine, also at each segment count. K7
# also on windows that take every leg of the complete addition.

MSM_R = np.array([
    0x1234567890ABCDE5, 0x0FEDCBA987654325, 0x1111111111111171,
    0x2222222222222272, 0x3333333333333373, 0x4444444444444444,
    0x5555555555555555, 0x6666666666666666,
], np.uint64)


@pytest.mark.cuda
@pytest.mark.parametrize("skipped", ["one", "all"])
def test_msm_kernels_match_plain_and_oracle(skipped):
    _card()
    g = g2_generator()
    pts = [g.mul(3 + 7 * i) for i in range(8)]
    pts[1] = pts[0]
    pts[3] = pts[2].neg()
    skip = np.ones(8, bool) if skipped == "all" else np.arange(8) == 7
    idx, valid = msm.build_schedule(MSM_R, msm.max_rounds(8), skip)
    sx, sy, _ = points.g2_to_dev(pts)
    sx, sy, idx, valid = _cuda(sx, sy, idx, valid)
    before = {k.name: k.launches for k in (msm.K5, msm.K6, msm.K7)}
    got = msm.accumulate(sx, sy, idx, valid)
    B = msm.accum_plain(sx, sy, idx, valid)
    k = msm.accum_segments(idx.shape[0])
    assert _same(got, msm.accum_segments_plain(sx, sy, idx, valid, k))
    assert _same(tc.to_affine_g2(got), tc.to_affine_g2(B))
    T = msm.tree(B)
    assert _same(T, msm.tree_plain(B))
    H = msm.horner(T)
    assert _same(H, msm.horner_plain(T))
    assert {k.name: k.launches for k in (msm.K5, msm.K6, msm.K7)} == {
        k: v + 1 for k, v in before.items()}
    x, y, inf = tc.to_affine_g2(H)
    want = g2_infinity()
    for p, k, sk in zip(pts, MSM_R, skip):
        if not sk:
            want = want.add(p.mul(int(k)))
    assert points.g2_from_dev(x, y, inf) == [want]


# K5's segments per bucket, each on a group of 8 threads
K5_SEGMENTS = [1, 2, 4, 8, 16, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("segments", K5_SEGMENTS, ids=lambda k: f"8x{k}")
def test_accumulate_shapes_match_model(segments):
    """K5 at a given number of segments through lh_msm_accum_shaped, on the
    edge batch: raw-equal to its segment model and equal to accum_plain at
    canonical affine."""
    import ctypes

    from lighthouse_tpu_torch.ops import _build

    _card()
    g = g2_generator()
    pts = [g.mul(3 + 7 * i) for i in range(8)]
    pts[1] = pts[0]
    pts[3] = pts[2].neg()
    idx, valid = msm.build_schedule(MSM_R, msm.max_rounds(8), np.arange(8) == 7)
    sx, sy, _ = points.g2_to_dev(pts)
    sx, sy, idx, valid = _cuda(sx, sy, idx, valid)
    out = torch.empty(3, 256, 2, 48, dtype=torch.int32, device="cuda")
    rc = msm.K5.library.load().lh_msm_accum_shaped(
        ctypes.c_int(segments),
        *(ctypes.c_void_p(t.data_ptr()) for t in (sx, sy, idx, valid, *out)),
        ctypes.c_int(idx.shape[0]), ctypes.c_int(8), ctypes.c_longlong(256),
        ctypes.c_void_p(_build.current_stream(sx)))
    assert rc == 0
    got = tuple(out)
    assert _same(got, msm.accum_segments_plain(sx, sy, idx, valid, segments))
    assert _same(tc.to_affine_g2(got), tc.to_affine_g2(msm.accum_plain(sx, sy, idx, valid)))


@pytest.mark.cuda
def test_tree_kernel_edge_buckets():
    """K6 (a block per window, a lane on 16 threads) on the edge batch's
    buckets and on the edge buckets (a window wholly at infinity, the
    doubling, the cancellation): raw-equal to tree_plain on all 256 lanes,
    one launch each."""
    _card()
    g = g2_generator()
    pts = [g.mul(3 + 7 * i) for i in range(8)]
    pts[1] = pts[0]
    pts[3] = pts[2].neg()
    idx, valid = msm.build_schedule(MSM_R, msm.max_rounds(8), np.arange(8) == 7)
    sx, sy, _ = points.g2_to_dev(pts)
    sx, sy, idx, valid = _cuda(sx, sy, idx, valid)
    for B in (msm.accum_plain(sx, sy, idx, valid),
              tuple(c.cuda() for c in tree_edge_buckets(torch))):
        before = msm.K6.launches
        assert _same(msm.tree(B), msm.tree_plain(B))
        assert msm.K6.launches == before + 1


@pytest.mark.cuda
def test_horner_kernel_edge_windows():
    """K7 raw-equal to horner_plain on windows that take every leg of the
    complete addition."""
    _card()
    T = tuple(c.cuda() for c in horner_edge_windows(torch))
    before = msm.K7.launches
    got = msm.horner(T)
    assert msm.K7.launches == before + 1
    assert _same(got, msm.horner_plain(T))


# ------------------------------------------------- constants in the sources

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"


def _source_words(text, name):
    """The integer whose little-endian 32-bit words a source's constant
    array ``name`` holds."""
    body = re.search(rf"\b{name}\[[^=]*=\s*\{{(.*?)\}};", text, re.S).group(1)
    return sum(int(w, 16) << (32 * k)
               for k, w in enumerate(re.findall(r"0x([0-9a-f]{8})u", body)))


def _naf(k):
    """The non-adjacent form of k > 0, least significant digit first."""
    digits = []
    while k:
        d = 2 - k % 4 if k % 2 else 0
        digits.append(d)
        k = (k - d) // 2
    return digits


def test_subgroup_order_words_match_python():
    """K15's digit words are the NAF of the curve order r: the positive and
    negative digits of _naf(R), its top digit at kOrderNafTop."""
    text = (CSRC / "subgroup_fast.cu").read_text()
    digits = _naf(ORDER)
    pos, neg = (_source_words(text, name) for name in ("kOrderNafPos", "kOrderNafNeg"))
    assert pos == sum(1 << i for i, d in enumerate(digits) if d == 1)
    assert neg == sum(1 << i for i, d in enumerate(digits) if d == -1)
    top = int(re.search(r"kOrderNafTop = (\d+);", text).group(1))
    assert top == len(digits) - 1 == 255


def test_subgroup_order_naf_is_the_short_chain():
    """The NAF in the source: its digits give back r, no two adjacent are
    nonzero, 60 of 256 are (255 doublings and 59 mixed additions, against
    the binary chain's 254 and 133), and the last is +1 (the mixed addition
    of Q onto [r - 1]Q = -Q)."""
    text = (CSRC / "subgroup_fast.cu").read_text()
    pos, neg = (_source_words(text, name) for name in ("kOrderNafPos", "kOrderNafNeg"))
    assert pos - neg == ORDER and pos & neg == 0
    nonzero = pos | neg
    assert nonzero & (nonzero >> 1) == 0
    assert bin(nonzero).count("1") == 60 and nonzero.bit_length() == 256
    assert bin(ORDER).count("1") - 1 == 133
    assert pos & 1 and pos >> 255 == 1


@pytest.mark.parametrize("name, value", [
    ("kBuckets", msm.N_BUCKETS), ("kLanes", msm._LANES),
    ("kWindows", msm.N_WINDOWS), ("kWindowBits", msm.WINDOW_BITS),
])
def test_msm_layout_constants_match_python(name, value):
    text = (CSRC / "msm.cu").read_text()
    assert int(re.search(rf"\b{name} = (\d+);", text).group(1)) == value


# ------------------------------------------------------- the hash kernels
# K12 (resident map), K13 (SSWU + isogeny) and K14 (cofactor) against their
# plain versions on the same CUDA tensors, with the edge lanes: u = 0 on
# both halves, u0 == u1 (Q0 + Q1 takes the doubling), a lane at infinity.


def _hash_inputs():
    u = torch.from_numpy(htc.hash_to_field_dev([b"", b"abc", b"lighthouse"]))
    zero = torch.zeros(1, 2, 2, 48, dtype=torch.int32)
    twin = u[1:2, :1].expand(1, 2, 2, 48)
    return torch.cat([u, zero, twin]).cuda()


@pytest.mark.cuda
def test_hash_kernels_match_plain():
    _card()
    us = _hash_inputs()
    n = us.shape[0]
    before = {k.name: k.launches for k in (th.K12, th.K13, th.K14)}
    assert _same(th.map_to_g2_resident(us), th.map_to_g2_resident_plain(us))
    flat = torch.cat([us[:, 0], us[:, 1]])
    J = th.sswu_iso(flat)
    assert _same(J, th.sswu_iso_plain(flat))
    Q = points.pt_add(points.FP2_OPS, tuple(c[:n] for c in J), tuple(c[n:] for c in J))
    Q = tuple(c.clone() for c in Q)
    Q[2][0] = 0  # a lane at infinity
    assert _same(th.clear_cofactor(Q), th.cofactor_plain(Q))
    assert {k.name: k.launches for k in (th.K12, th.K13, th.K14)} == {
        k: v + 1 for k, v in before.items()}


@pytest.mark.cuda
def test_device_hash_matches_oracle_resident_and_chained():
    _card()
    msgs = [b"", b"abc", b"lighthouse", b"abc"]
    want = points.g2_to_dev([hash_to_g2(m) for m in msgs])
    for resident in (True, False):
        got = th.hash_to_g2_fused_dev(msgs, resident=resident)
        assert got[0].device.type == "cuda"
        for g, w in zip(got, want):
            assert np.array_equal(g.cpu().numpy(), w)


@pytest.mark.cuda
def test_table_build_on_card_matches_cpu_and_golden():
    """The registry built on the card (K3 G1 once, then per step the mixed
    addition on K1 and K2 G1) is byte-equal to the CPU build and to the
    golden build (K3 G1 and K2 G1 per chunk)."""
    _card()
    from lighthouse_tpu_torch import blsrt

    before = (tc.K3_G1.launches, tc.K2_G1.launches)
    card = blsrt.build_sequential_table(40, chunk=16)
    assert (tc.K3_G1.launches, tc.K2_G1.launches) == (before[0] + 1, before[1] + 3)
    for other in (blsrt.build_sequential_table(40, chunk=16, device="cpu"),
                  blsrt._build_sequential_table_scalarmul(40, chunk=16)):
        for mine, theirs in zip(card.host_planes(), other.host_planes()):
            assert np.array_equal(mine, theirs)


@pytest.mark.cuda
def test_indexed_verify_on_card_and_the_table_device():
    """Sets with validator indices verify from the table on the card (the
    indexed path); a backend on another device refuses that table."""
    _card()
    from lighthouse_tpu_torch import blsrt
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.torch_backend import TorchBackend

    sks = [api.SecretKey.from_int(i + 7) for i in range(3)]
    m0, m1 = b"\x11" * 32, b"\x22" * 32
    sets = [api.SignatureSet.single_pubkey(sks[0].sign(m0), sks[0].public_key(), m0,
                                           index=0),
            api.SignatureSet.multiple_pubkeys(
                api.AggregateSignature.aggregate([sks[1].sign(m1), sks[2].sign(m1)]),
                [sks[1].public_key(), sks[2].public_key()], m1, indices=[1, 2])]
    table = blsrt.DevicePubkeyTable()
    table.append_pubkeys([sk.public_key() for sk in sks])
    blsrt.set_device_table(table)
    try:
        be = TorchBackend()
        assert be.verify_signature_sets(sets) is True
        assert be.last_path == "indexed" and table.device.type == "cuda"
        with pytest.raises(ValueError, match="lives on cuda"):
            TorchBackend(device="cpu").verify_signature_sets(sets)
    finally:
        blsrt.set_device_table(None)
