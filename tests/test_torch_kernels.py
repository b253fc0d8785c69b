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

from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.constants import R as ORDER
from lighthouse_tpu_torch.crypto.bls.curve import g1_generator, g2_generator, g2_infinity
from lighthouse_tpu_torch.crypto.bls.fields import Fq2
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2, map_to_curve_g2
from lighthouse_tpu_torch.ops import field, htc, mont_mul, msm, pairing, points
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
@pytest.mark.parametrize("shape", [(4000,), (3, 5, 7), (0,)])
def test_kernel_matches_plain_and_bigint(shape):
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


# ------------------------------------------------------ the fused kernels
# Each fused kernel (ops/tkernel_calls.py) against its plain version on the
# same CUDA tensors, at small shapes with the edge lanes of the verify path:
# infinity, Z = 1, scalars 0, 1 and 2^64 - 1, points outside G2. Raw limbs
# must be equal (the CUDA tower follows ops/tower.py op for op), which
# implies equality after canonical.

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


@pytest.mark.cuda
@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_and_to_affine_kernels_match_plain(group):
    _card()
    gen, F, pack, k3 = _group(group)
    x, y, inf = _cuda(*pack([gen.mul(k) for k in (2, 3, 5, 7, 11)]))
    inf[4] = True
    bits = _cuda(points.scalars_to_bits(SCALARS + [5], 64))[0]
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
    assert got[2].tolist() == [True, False, False, False, True]  # [0]Q, inf


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
    assert _same(g, tc.easy_exp_plain(f))
    for xm1 in (False, True):
        assert _same(tc.pow_x(g, xm1), tc.pow_x_plain(g, xm1))
    for mode in tc.COMB_MODES:
        assert _same(tc.comb(f, g, mode), tc.comb_plain(f, g, mode))
    assert _same(tc.final_exp_kernel(f[:1]), pairing.final_exponentiation(f[:1]))


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


# ------------------------------------------------------- the MSM kernels
# K5 (accumulate), K6 (tree) and K7 (Horner) against their plain versions on
# 8 sets with the edge cases: a duplicate signature whose mixed addition
# doubles, S and -S cancelling in a bucket before a further addition, empty
# buckets, a skipped set; and with every set skipped.

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
    B = msm.accumulate(sx, sy, idx, valid)
    assert _same(B, msm.accum_plain(sx, sy, idx, valid))
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


# ------------------------------------------------- constants in the sources

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"


def test_subgroup_order_words_match_python():
    text = (CSRC / "subgroup.cu").read_text()
    body = re.search(r"\bkOrder\[[^=]*=\s*\{(.*?)\};", text, re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    assert words == [(ORDER >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    top = int(re.search(r"kOrderTopBit = (\d+);", text).group(1))
    assert top == ORDER.bit_length() - 1 == 254


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
