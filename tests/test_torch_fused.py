"""The port's fused verify path on the CPU, against the JAX package.

On CPU tensors each fused-kernel wrapper (``ops/tkernel_calls.py``) runs its
plain version; these tests hold those plain versions, and
``TorchBackend(fused=True)`` as a whole, to the JAX package's pure-Python
oracle (``lighthouse_tpu.crypto.bls``) and its limb packing
(``lighthouse_tpu.ops.points.g1_to_dev`` / ``g2_to_dev``), so the fast tier
traces no JAX program. The tolerance is exact equality of canonical int32
limbs (affine points and Fp12 values after ``canonical``) and of verdicts.

The slow tier compares with the JAX package's fused Pallas kernels in
interpret mode and with its classic verify program on identical operands.
The kernels themselves need the card: ``tests/test_torch_kernels.py``.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu.crypto.bls.curve import (
    g1_generator,
    g2_generator,
    g2_subgroup_check,
)
from lighthouse_tpu.crypto.bls.fields import Fq2
from lighthouse_tpu.crypto.bls.hash_to_curve import hash_to_g2, map_to_curve_g2
from lighthouse_tpu.crypto.bls.pairing import pairing as oracle_pairing
from lighthouse_tpu.ops import points as jpoints
from lighthouse_tpu_torch.crypto.bls.constants import P, X
from lighthouse_tpu_torch.ops import _build, field, msm, pairing, points, tower
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from lighthouse_tpu_torch.ops import tkernel_htc as th
from lighthouse_tpu_torch.ops.points import FP2_OPS, FP_OPS
from lighthouse_tpu_torch.torch_backend import TorchBackend, _verify_core_fused
from tests.test_torch_backend import CASES, _case

from lighthouse_tpu.crypto.bls.api import verify_signature_sets_python

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "lighthouse_tpu_torch" / "csrc"
G1, G2 = g1_generator(), g2_generator()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain CPU path runs thousands of tiny ops; intra-op threads
    only spin on them (and fight the other test workers for cores)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _g(name):
    """(generator, port ops, JAX packing, port packing) of one group."""
    if name == "g1":
        return G1, FP_OPS, jpoints.g1_to_dev, points.g1_to_dev
    return G2, FP2_OPS, jpoints.g2_to_dev, points.g2_to_dev


# ------------------------------------------------------------- K2, K3


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_plain_matches_oracle(group):
    """K2's plain version on 4 Jacobian lanes (Z != 1 from a doubling, one
    Z = 1 lane, one at infinity): canonical limbs of the oracle's 2P."""
    gen, F, jpack, pack = _g(group)
    pts = [gen.mul(k) for k in (3, 5, 7, 11)]
    x, y, inf = _t(*pack(pts))
    inf[2] = True
    J = points.pt_double(F, points.pt_from_affine(F, x, y, inf))
    J = tuple(torch.cat([c[:3], a[3:]]) for c, a in
              zip(J, points.pt_from_affine(F, x, y, inf)))  # lane 3: Z = 1
    ax, ay, ainf = (tc.to_affine_g1 if group == "g1" else tc.to_affine_g2)(J)
    want = [pts[0].double(), pts[1].double(), gen.mul(0), pts[3]]
    ex, ey, einf = jpack(want)
    np.testing.assert_array_equal(ax.numpy(), ex)
    np.testing.assert_array_equal(ay.numpy(), ey)
    np.testing.assert_array_equal(ainf.numpy(), einf)


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_scalar_mul_plain_matches_oracle(group):
    """K3's plain version on 2 lanes of 64-bit scalars, one of them 0."""
    gen, F, jpack, pack = _g(group)
    pts = [gen.mul(13), gen.mul(29)]
    ks = [0xD201000000010001, 0]
    x, y, inf = _t(*pack(pts))
    bits = torch.from_numpy(points.scalars_to_bits(ks, 64))
    J = (tc.scalar_mul_g1 if group == "g1" else tc.scalar_mul_g2)(x, y, inf, bits)
    ax, ay, ainf = points.pt_to_affine(F, J)
    ex, ey, einf = jpack([p.mul(k) for p, k in zip(pts, ks)])
    np.testing.assert_array_equal(ax.numpy(), ex)
    np.testing.assert_array_equal(ay.numpy(), ey)
    np.testing.assert_array_equal(ainf.numpy(), einf)


# ------------------------------------------------------------------ K4


def test_subgroup_fast_plain_matches_oracle():
    """K4's plain version: True on hash_to_g2 points and infinity, False on
    map_to_curve_g2 outputs outside G2; each equal to the oracle's test."""
    pts = [hash_to_g2(b"\x11" * 32), map_to_curve_g2(Fq2(2, 1)),
           hash_to_g2(b"\x22" * 32), map_to_curve_g2(Fq2(5, 7))]
    x, y, inf = _t(*jpoints.g2_to_dev(pts))
    got = tc.subgroup_check_g2_fast(x, y, inf).tolist()
    assert got == [g2_subgroup_check(p) for p in pts] == [True, False, True, False]
    inf[1] = True  # an infinity lane passes
    assert tc.subgroup_check_g2_fast(x, y, inf).tolist() == [True, True, True, False]


# --------------------------------------------------------------- K8-K11


def test_pairing_chain_plain_matches_oracle():
    """K8's plain Miller loop then the 9-step K9-K11 chain on one pair:
    the oracle's pairing after canonical, and the classic final
    exponentiation's limbs exactly."""
    p, q = G1.mul(17), hash_to_g2(b"\x33" * 32)
    px, py, pinf = _t(*points.g1_to_dev([p]))
    qx, qy, qinf = _t(*points.g2_to_dev([q]))
    f = tc.miller_loop((px, py), pinf, (qx, qy), qinf)
    e = tc.final_exp_kernel(f)
    want = tower.fq12_to_dev(oracle_pairing(p, q))
    np.testing.assert_array_equal(field.canonical(e)[0].numpy(), want)
    assert torch.equal(e, pairing.final_exponentiation(f))


def test_miller_seg_matches_classic_miller_loop():
    """Sparse line products (K8's schedule) against the classic dense
    embedding: equal after canonical, on a live lane and a lane with Q at
    infinity (which yields Fp12 one)."""
    px, py, pinf = _t(*points.g1_to_dev([G1.mul(5), G1.mul(6)]))
    qx, qy, qinf = _t(*points.g2_to_dev([G2.mul(7), G2.mul(8)]))
    qinf[1] = True
    seg = tc.miller_loop((px, py), pinf, (qx, qy), qinf)
    classic = pairing.miller_loop((px, py), pinf, (qx, qy), qinf)
    assert torch.equal(field.canonical(seg), field.canonical(classic))
    assert bool(tower.fp12_is_one(seg[1])) and not bool(tower.fp12_is_one(seg[0]))


# ----------------------------------------------------- the slice as a whole


@pytest.mark.parametrize("name, want", [CASES[0], CASES[2]])
def test_fused_backend_matches_oracle(name, want):
    sets = _case(name)
    be = TorchBackend(device="cpu", fused=True)
    assert be.fused and be._core is _verify_core_fused
    assert verify_signature_sets_python(sets) is want
    assert be.verify_signature_sets(sets) is want
    assert be.last_operand_device == torch.device("cpu")
    assert be.msm and "msm_schedule" in be.last_stage_seconds  # the MSM's path


def test_default_path_follows_device():
    """fused=None: classic on the CPU (fused is the card's default)."""
    assert TorchBackend(device="cpu").fused is False
    assert TorchBackend(device="cpu", fused=False).fused is False


# ------------------------------------------------ wrappers without a card

_FP, _FP2, _FP12 = (48,), (2, 48), (2, 3, 2, 48)


def _i32(*shape):
    return torch.zeros(*shape, dtype=torch.int32)


def _mask(n):
    return torch.zeros(n, dtype=torch.bool)


WRAPPERS = {
    "to_affine_g1": lambda a: tc.to_affine_g1((a(2, *_FP), _i32(2, *_FP), _i32(2, *_FP))),
    "to_affine_g2": lambda a: tc.to_affine_g2((a(2, *_FP2), _i32(2, *_FP2), _i32(2, *_FP2))),
    "scalar_mul_g1": lambda a: tc.scalar_mul_g1(a(2, *_FP), _i32(2, *_FP), _mask(2), _i32(2, 64)),
    "scalar_mul_g2": lambda a: tc.scalar_mul_g2(a(2, *_FP2), _i32(2, *_FP2), _mask(2), _i32(2, 64)),
    "subgroup_fast": lambda a: tc.subgroup_check_g2_fast(a(2, *_FP2), _i32(2, *_FP2), _mask(2)),
    "miller": lambda a: tc.miller_loop((a(2, *_FP), _i32(2, *_FP)), _mask(2),
                                       (_i32(2, *_FP2), _i32(2, *_FP2)), _mask(2)),
    "easy_exp": lambda a: tc.easy_exp(a(2, *_FP12)),
    "pow_x": lambda a: tc.pow_x(a(2, *_FP12), True),
    "comb": lambda a: tc.comb(a(2, *_FP12), _i32(2, *_FP12), "c"),
    "map_to_g2": lambda a: th.map_to_g2_resident(a(2, 2, *_FP2)),
    "sswu_iso": lambda a: th.sswu_iso(a(2, *_FP2)),
    "cofactor": lambda a: th.clear_cofactor((a(2, *_FP2), _i32(2, *_FP2), _i32(2, *_FP2))),
    "subgroup_full": lambda a: tc.subgroup_check_g2(a(2, *_FP2), _i32(2, *_FP2), _mask(2)),
    "msm_accum": lambda a: msm.accumulate(a(2, *_FP2), _i32(2, *_FP2), _i32(8, 240),
                                          torch.zeros(8, 240, dtype=torch.bool)),
    "msm_tree": lambda a: msm.tree((a(256, *_FP2), _i32(256, *_FP2), _i32(256, *_FP2))),
    "msm_horner": lambda a: msm.horner((a(256, *_FP2), _i32(256, *_FP2), _i32(256, *_FP2))),
}

# A tensor on the meta device is not a CPU tensor, so it takes the kernel's
# road, where the checks stop it before any library is built or loaded.
FAULTS = {
    "dtype": (lambda *s: torch.zeros(*s, dtype=torch.int64, device="meta"),
              TypeError, "wants torch.int32"),
    "last_dim": (lambda *s: torch.zeros(*s[:-1], s[-1] - 1, dtype=torch.int32,
                                        device="meta"), ValueError, "wants shape"),
    "device_mix": (lambda *s: torch.zeros(*s, dtype=torch.int32, device="meta"),
                   ValueError, "one CUDA device"),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_fused_wrapper_rejects(wrapper, fault):
    make, err, match = FAULTS[fault]
    before = {k.name: k.launches for k in _build.KERNELS}
    with pytest.raises(err, match=match):
        WRAPPERS[wrapper](make)
    assert {k.name: k.launches for k in _build.KERNELS} == before


def test_comb_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        tc.comb(_i32(1, *_FP12), _i32(1, *_FP12), "d")


# --------------------------------------------------------- registrations


@pytest.mark.parametrize("kernel", _build.KERNELS, ids=lambda k: k.name)
def test_kernel_names_its_tpu_kernel_and_source(kernel):
    """Each registered kernel's ``replaces`` points at the line of the
    Pallas kernel it replaces, and its source exists."""
    path, rest = kernel.replaces.split(":")
    line, func = rest.split(" ", 1)
    src = (REPO / path).read_text().splitlines()
    assert f"def {func.split('(')[0]}" in src[int(line) - 1]
    assert (REPO / kernel.source).is_file()
    assert kernel.route == "cuda"


# --------------------------------------------- constants hard-coded in csrc


def _words(x: int, n: int = 12):
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(n)]


def _fp2_words(limbs):
    return [_words(field.limbs_to_int(limbs[i])) for i in range(2)]


CONSTANTS = {
    ("fp.cuh", "kP"): _words(P),
    ("fp.cuh", "kTwoP"): _words(2 * P),
    ("fp.cuh", "kOne"): _words(field.R_MONT),
    ("fp.cuh", "kPMinus2"): _words(P - 2),
    ("tower.cuh", "kFrob6C1"): _fp2_words(tower.FROB6_C1),
    ("tower.cuh", "kFrob6C2"): _fp2_words(tower.FROB6_C2),
    ("tower.cuh", "kFrob12C1"): _fp2_words(tower.FROB12_C1),
    ("curve.cuh", "kPsiCx"): _fp2_words(points.PSI_CX_DEV),
    ("curve.cuh", "kPsiCy"): _fp2_words(points.PSI_CY_DEV),
}


@pytest.mark.parametrize("where", sorted(CONSTANTS), ids=lambda w: w[1])
def test_header_constants_match_python(where):
    header, name = where
    text = (CSRC / header).read_text()
    body = re.search(rf"\b{name}\[[^=]*=\s*\{{(.*?)\}};", text, re.S).group(1)
    words = [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]
    want = CONSTANTS[where]
    flat = [w for row in want for w in row] if isinstance(want[0], list) else want
    assert words == flat


def test_header_scalar_constants_match_python():
    fp_h = (CSRC / "fp.cuh").read_text()
    curve_h = (CSRC / "curve.cuh").read_text()
    assert int(re.search(r"kNInv = (0x[0-9a-f]+)u", fp_h).group(1), 16) == \
        (-pow(P, -1, 1 << 32)) % (1 << 32)
    assert int(re.search(r"kPMinus2TopBit = (\d+);", fp_h).group(1)) == \
        (P - 2).bit_length() - 1
    assert int(re.search(r"kXAbs = (0x[0-9a-f]+)ull", curve_h).group(1), 16) == -X
    assert int(re.search(r"kXTopBit = (\d+);", curve_h).group(1)) == \
        (-X).bit_length() - 1
    assert points.X_BITS == bin(-X)[3:] and points.X_BITS.count("1") == 5


# ----------------------------------------------------------------- slow tier
# The JAX package's fused Pallas kernels in interpret mode (minutes to trace
# each) and its verify programs, against the port's plain versions.


@pytest.mark.slow
def test_plain_versions_match_jax_fused_kernels():
    """tkernel_calls.to_affine_g1_t, scalar_mul_g1_t and
    subgroup_check_g2_fast_t (interpret mode, T=2) against K2, K3 and K4's
    plain versions on the same operands: equal after canonical."""
    import jax.numpy as jnp

    from lighthouse_tpu.ops import tkernel as tk
    from lighthouse_tpu.ops import tkernel_calls as jtc

    x, y, inf = jpoints.g1_to_dev([G1.mul(3), G1.mul(10)])
    bits = points.scalars_to_bits([0xD201000000010001, 5], 64)
    tx, ty, tinf, tbits = _t(x, y, inf, bits)
    mask = jnp.asarray(inf)[None, :].astype(jnp.int32)
    J = jtc.scalar_mul_g1_t(tk.batch_to_t(x), tk.batch_to_t(y), mask,
                            jnp.asarray(bits.T))
    mine = tc.scalar_mul_g1(tx, ty, tinf, tbits)
    for a, b in zip(J, mine):
        np.testing.assert_array_equal(
            field.canonical(torch.from_numpy(np.array(tk.batch_from_t(a)))).numpy(),
            field.canonical(b).numpy())
    ax, ay, ainf = jtc.to_affine_g1_t(J)
    mx, my, minf = tc.to_affine_g1(mine)
    np.testing.assert_array_equal(np.asarray(tk.batch_from_t(ax)), mx.numpy())
    np.testing.assert_array_equal(np.asarray(tk.batch_from_t(ay)), my.numpy())
    np.testing.assert_array_equal(np.asarray(ainf), minf.numpy())

    pts = [hash_to_g2(b"\x44" * 32), map_to_curve_g2(Fq2(3, 4))]
    sx, sy, sinf = jpoints.g2_to_dev(pts)
    smask = jnp.asarray(sinf)[None, :].astype(jnp.int32)
    want = jtc.subgroup_check_g2_fast_t(tk.batch_to_t(sx), tk.batch_to_t(sy), smask)
    got = tc.subgroup_check_g2_fast(*_t(sx, sy, sinf))
    assert list(np.asarray(want)) == got.tolist() == [True, False]


@pytest.mark.slow
def test_fused_core_matches_jax_core_on_identical_operands():
    """The port's _verify_core_fused and the JAX classic program on the
    operands JaxBackend._dispatch packs: the same verdict; the fused path's
    K2 aggregates equal the oracle's, limb for limb."""
    from lighthouse_tpu import jax_backend
    from lighthouse_tpu.crypto.bls.curve import g1_infinity
    from lighthouse_tpu_torch import interop
    from lighthouse_tpu_torch.torch_backend import _aggregate_jacobian
    from tests.test_torch_backend import _packed_valid_operands

    ops_np, sets = _packed_valid_operands()
    px, py, pinf, sx, sy, sinf, mx, my, minf, r_bits = ops_np
    want = bool(jax_backend._verify_jit(
        (px, py), pinf, (sx, sy), sinf, (mx, my), minf, r_bits
    ))
    ops = interop.operands_from_numpy(*ops_np, device="cpu")
    assert bool(_verify_core_fused(*ops)) == want is True
    ax, ay, ainf = tc.to_affine_g1(_aggregate_jacobian(ops[0], ops[1]))
    agg = []
    for s in sets:
        acc = g1_infinity()
        for pk in s.signing_keys:
            acc = acc.add(pk.point)
        agg.append(acc)
    ex, ey, einf = jpoints.g1_to_dev(agg)
    np.testing.assert_array_equal(ax.numpy(), ex)
    np.testing.assert_array_equal(ay.numpy(), ey)
    np.testing.assert_array_equal(ainf.numpy(), einf)


@pytest.mark.slow
@pytest.mark.parametrize("name, want", [CASES[1], CASES[3], CASES[4]])
def test_fused_backend_matches_jax_backend(name, want):
    from lighthouse_tpu.crypto.bls.backends import get_backend

    sets = _case(name)
    assert bool(get_backend("jax").verify_signature_sets(sets)) is want
    assert verify_signature_sets_python(sets) is want
    assert TorchBackend(device="cpu", fused=True).verify_signature_sets(sets) is want
