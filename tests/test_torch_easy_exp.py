"""K9, the easy part of the final exponentiation, as a block program with one
divstep inversion (``ops/coop.py`` ``easy_exp_plan``), on the CPU.

The plan is a norm program (``ops/tower.py`` fp12_inv, fp6_inv and fp2_inv
down to the one Fp value fp2_inv inverts), one inversion step (``csrc/fp.cuh``
``fp_inv_gcd``, modelled by ``coop.invert_model``) and a back program (up to
inv(f), then conj(f) inv(f) and frobenius2(g) g). Its programs must give the
tower's limbs exactly; the inversion the divstep GCD's representative, which
may differ from Fermat's in [0, 2p), so the whole plan equals
``easy_exp_plain`` after ``canonical``. ``csrc/final_exp.cu``'s K9 body,
built with the host C++ compiler on the block harness of
``tests/test_torch_affine_host.py`` (64 ``std::thread``s and a barrier for
``__syncthreads``), must equal the plan's model limb for limb. The kernel
itself runs on the card (``chip_smoke.py``, ``tests/test_torch_kernels.py``).
"""

import ctypes
import random
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.curve import g1_generator, g2_generator
from lighthouse_tpu_torch.ops import coop, field, points, tower
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from lighthouse_tpu_torch.ops.tkernel_pairing import miller_loop_seg
from tests.test_torch_affine_host import SHIM
from tests.test_torch_htc_host import harness_call

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"
R = 1 << 384
NORM, BACK = coop.easy_exp_programs()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fp12(seed, n):
    """Random Fp12 limbs in [0, 2p), int32 [n, 2, 3, 2, 48]."""
    a = np.random.default_rng(seed).integers(0, 256, size=(n, 2, 3, 2, 48), dtype=np.int32)
    a[..., 47] %= 0x34  # 2p's top byte is 0x34
    return torch.from_numpy(a)


def _slots(f):
    """K9's fixed slots as the plan loads them: f, then the constants."""
    n = f.shape[0]
    slots = torch.zeros(n, max(NORM.n_slots, BACK.n_slots), 48, dtype=torch.int32)
    slots[:, coop.EXP_F:coop.EXP_F + 12] = f.reshape(n, 12, 48)
    slots[:, coop.EXP_C:coop.EXP_C + 6] = coop.easy_exp_consts("cpu")
    return slots


@pytest.fixture(scope="module")
def miller_outputs():
    """Two Miller loop outputs: a pair of finite points, and a pair with P
    at infinity (f = 1)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))
    px, py, pinf = map(t, points.g1_to_dev([g1_generator().mul(k) for k in (3, 4)]))
    qx, qy, qinf = map(t, points.g2_to_dev([g2_generator().mul(k) for k in (6, 7)]))
    pinf[1] = True
    f = miller_loop_seg((px, py), pinf, (qx, qy), qinf)
    assert torch.equal(f[1], torch.from_numpy(tower.FP12_ONE))
    return f


# ------------------------------------------------------------ the programs


def test_norm_program_matches_the_tower_intermediates():
    """The norm program leaves, limb for limb, what ops/tower.py computes on
    the way to its one inversion: fp6_inv's t and fp2_inv's input d (of
    fp12_inv's denominator) and d's norm c0^2 + c1^2."""
    f = _fp12(1, 3)
    a0, a1 = f[:, 0], f[:, 1]
    s = tower.fp6_mul(torch.stack((a0, a1)), torch.stack((a0, a1)))
    denom = field.sub(s[0], tower.fp6_mul_by_v(s[1]))
    c0, c1, c2 = denom[:, 0], denom[:, 1], denom[:, 2]
    m = tower.fp2_mul(torch.stack((c0, c1, c2, c0, c1, c0)),
                      torch.stack((c0, c2, c2, c1, c1, c2)))
    a_sq, bc, c_sq, ab, b_sq, ac = m
    xi = tower.fp2_mul_by_xi(torch.stack((bc, c_sq)))
    t = field.sub(torch.stack((a_sq, xi[1], b_sq)), torch.stack((xi[0], ab, ac)))
    n = tower.fp2_mul(torch.stack((c0, c2, c1)), t)
    d = field.add(n[0], tower.fp2_mul_by_xi(field.add(n[1], n[2])))
    sq = field.mont_mul(d, d)
    norm = field.add(sq[:, 0], sq[:, 1])
    slots = _slots(f)
    coop.run_program(NORM, slots)
    assert torch.equal(slots[:, coop.EXP_T:coop.EXP_T + 6], t.permute(1, 0, 2, 3).reshape(-1, 6, 48))
    assert torch.equal(slots[:, coop.EXP_D:coop.EXP_D + 2], d)
    assert torch.equal(slots[:, coop.EXP_N], norm)


def test_programs_with_fermat_between_them_are_the_plain_easy_part():
    """With Fermat's inverse of the norm (field.mont_inv, what fp2_inv
    takes) between them, the two programs give easy_exp_plain limb for
    limb: the back program transcribes the rest of the tower's inversion,
    conj(f) inv(f) and frobenius2(g) g op for op."""
    f = _fp12(2, 3)
    slots = _slots(f)
    coop.run_program(NORM, slots)
    slots[:, coop.EXP_N] = field.mont_inv(slots[:, coop.EXP_N])
    coop.run_program(BACK, slots)
    got = slots[:, coop.EXP_F:coop.EXP_F + 12].reshape(f.shape)
    assert torch.equal(got, tc.easy_exp_plain(f))


def test_invert_model_is_the_montgomery_inverse():
    """The inversion step's model: on edge values and seeded ones in
    [0, 2p), a result r in [0, 2p) with r a = R^2 mod p (0 -> 0), equal to
    Fermat's inverse after canonical; on some inputs another
    representative than Fermat's, which is why K9 is held to its plain
    version after canonical."""
    rng = random.Random(5)
    xs = [0, 1, 2, P - 1, P, P + 1, 2 * P - 1, R % P] + [rng.randrange(2 * P) for _ in range(200)]
    a = torch.from_numpy(field.ints_to_limbs(xs))
    got = coop.invert_model(a)
    fermat = field.mont_inv(a)
    assert torch.equal(field.canonical(got), field.canonical(fermat))
    for x, r in zip(xs, got):
        r = field.limbs_to_int(r.numpy())
        assert r < 2 * P
        assert r * x % P == (R * R % P if x % P else 0)
    assert not torch.equal(got, fermat)


def test_plan_matches_plain_after_canonical(miller_outputs):
    """The whole plan (norm, divstep inversion, back) against
    easy_exp_plain after canonical: on Miller outputs (one of them f = 1,
    whose easy part is 1) and on seeded Fp12 values."""
    for f in (miller_outputs, _fp12(3, 2)):
        got = coop.easy_exp_steps(f)
        want = tc.easy_exp_plain(f)
        assert torch.equal(field.canonical(got), field.canonical(want))
    one = coop.easy_exp_steps(miller_outputs[1:])
    assert bool(tower.fp12_is_one(one).all())


# ------------------------------------------------------------- the rounds

# (product rounds, add rounds, Fp products) of K9's programs (PERF.md
# section 6): the norm's 4 product rounds, the back program's 9
ROUNDS = {"easy_norm": (4, 21, 65), "easy_back": (9, 57, 197)}


@pytest.mark.parametrize("program", [NORM, BACK], ids=lambda p: p.name)
def test_easy_exp_program_rounds(program):
    coop.check_rounds(program)
    assert (program.product_rounds, program.add_rounds, program.products) == \
        ROUNDS[program.name]
    assert max(len(r) for r in program.rounds) <= coop.THREADS


def test_easy_exp_plan_layout():
    """Norm, one inversion of the norm's slot, back; the packed plan keeps
    the negative inversion step, and the block's shared memory fits the
    default 48 KB."""
    plan = coop.easy_exp_plan()
    assert plan.steps == (coop.EXP_NORM, coop.invert_step(coop.EXP_N), coop.EXP_BACK)
    assert coop.rounds_per_lane(plan) == (13, 78, 262)
    buf = coop.pack(plan).astype(np.int64)
    n_progs, n_loads, n_stores, n_steps = buf[1:coop.HEADER]
    steps = buf[coop.HEADER + n_progs + 4 * n_loads + 2 * n_stores:][:n_steps]
    assert steps.tolist() == list(plan.steps)
    assert coop.shared_bytes(plan) <= 48 * 1024
    text = (CSRC / "coop.cuh").read_text()
    assert "invert(b, -1 - steps[s])" in text and "fp::fp_inv_gcd(r, x)" in text
    assert re.search(r"coop::run_lane<true>\(prog", (CSRC / "final_exp.cu").read_text())


# ---------------------------------------------------- the kernel body


# K9 on the block harness: 64 threads meeting at a barrier, a block at a
# time; coop.cuh's dynamic shared array is the harness's.
HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
thread_local Dim threadIdx, blockIdx;
Dim blockDim = {64, 1, 1}, gridDim = {1, 1, 1};
static std::barrier<>* g_block;
void __syncthreads() { g_block->arrive_and_wait(); }
namespace coop {
__attribute__((aligned(16))) uint32_t smem[1 << 14];
}
#include "final_exp_kernels.inc"
extern "C" void k9(const int* f, const int* consts, const short* prog, int* out,
                   int prog_len, long long n) {
  std::barrier<> block(64);
  g_block = &block;
  for (long long b = 0; b < n; ++b) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < 64; ++t)
      ts.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        easy_exp_kernel((const int4*)f, (const int4*)consts, (const int16_t*)prog,
                        (int4*)out, prog_len);
      });
    for (auto& t : ts) t.join();
  }
}
"""


def _without_launches(src: str) -> str:
    return re.sub(r"<<<.*?>>>", "", src, flags=re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """final_exp.cu's kernels (K9's body on coop.cuh) built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("easy_exp_host")
    src = (CSRC / "final_exp.cu").read_text()
    (out / "final_exp_kernels.inc").write_text(_without_launches(src[:src.index('extern "C"')]))
    # coop.cuh's launch helper, without its launch configuration, ahead of
    # the source's copy on the include path
    (out / "coop.cuh").write_text(_without_launches((CSRC / "coop.cuh").read_text()))
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libeasy_exp_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(out),
         "-I", str(CSRC), "-include", str(out / "shim.h"), "-o", str(lib),
         str(out / "harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "c++20" in proc.stderr:
        pytest.skip(f"{cxx} has no C++20 (std::barrier): {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(lib))
    h.k9.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong]
    return h


def test_easy_exp_kernel_body_matches_plan(host_lib, miller_outputs):
    """K9's body (the plan's loads, both programs, thread 0's divstep
    inversion between two barriers, the stores) limb for limb equal to
    coop.easy_exp_steps, on the Miller outputs (f = 1 among them) and
    seeded Fp12 values."""
    f = torch.cat([miller_outputs, _fp12(4, 3)]).contiguous()
    prog = coop.to_device(coop.easy_exp_plan(), "cpu")
    consts = coop.easy_exp_consts("cpu")
    out = torch.zeros_like(f)
    harness_call(lambda: host_lib.k9(*(ctypes.c_void_p(t.data_ptr()) for t in (f, consts, prog, out)),
                                     prog.numel(), f.shape[0]), out)
    assert torch.equal(out, coop.easy_exp_steps(f))
