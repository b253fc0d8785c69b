"""K11, the hard part's three combinations, as block programs
(``ops/coop.py`` ``comb_plan``), on the CPU.

Each mode is one program written with the tower operations of
``ops/tower.py`` in ``tkernel_calls.comb_plain``'s expression order
(b = u frob(v), c = u frob2(v) conj(v), final = u v^2 v), so the plan run
by ``coop.run_plan`` must give ``comb_plain``'s limbs exactly, on seeded
Fp12 values in [0, 2p) and on Miller loop outputs. ``csrc/final_exp.cu``'s
K11 body, built with the host C++ compiler on the block harness of
``tests/test_torch_easy_exp.py`` (64 ``std::thread``s and a barrier for
``__syncthreads``), must equal the plan's model limb for limb in each mode.
The kernel itself runs on the card (``chip_smoke.py``,
``tests/test_torch_kernels.py``).
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.ops import coop
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from tests.test_torch_affine_host import SHIM
from tests.test_torch_easy_exp import _fp12, _without_launches, miller_outputs  # noqa: F401
from tests.test_torch_htc_host import harness_call

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# (product rounds, add rounds, Fp products) of each mode's program (PERF.md
# section 6): b's Frobenius takes two product rounds before the product,
# c's two Frobenius maps four before two products, final's square one
# before two products
ROUNDS = {"b": (3, 21, 75), "c": (6, 42, 150), "final": (3, 34, 144)}


@pytest.mark.parametrize("mode", tc.COMB_MODES)
def test_comb_plan_is_the_plain_combination(mode, miller_outputs):  # noqa: F811
    """The plan, run by coop.run_plan, is comb_plain limb for limb: on
    seeded Fp12 values and on Miller outputs (u) against easy-part outputs
    (v), as the chain gives them."""
    u, v = _fp12(10, 3), _fp12(11, 3)
    assert torch.equal(coop.comb_steps(u, v, mode), tc.comb_plain(u, v, mode))
    g = tc.easy_exp_plain(miller_outputs)
    assert torch.equal(coop.comb_steps(miller_outputs, g, mode),
                       tc.comb_plain(miller_outputs, g, mode))


@pytest.mark.parametrize("mode", tc.COMB_MODES)
def test_comb_program_rounds(mode):
    """Each round reads no slot it writes and writes none twice; the round
    counts PERF.md states; a round's operations fit the block's 64
    threads in one pass; one step; the shared memory within the default
    48 KB; the Frobenius constants loaded at stride 0 only where used."""
    plan = coop.comb_plan(mode)
    (program,) = plan.programs
    coop.check_rounds(program)
    assert (program.product_rounds, program.add_rounds, program.products) == ROUNDS[mode]
    assert max(len(r) for r in program.rounds) <= coop.THREADS
    assert plan.steps == (0,)
    assert coop.rounds_per_lane(plan) == ROUNDS[mode]
    assert coop.shared_bytes(plan) <= 48 * 1024
    shared = [ld for ld in plan.loads if ld[2] == 0]
    assert len(shared) == (0 if mode == "final" else 6)
    assert all(ld[1] == 2 for ld in shared)


# K11 on the block harness: 64 threads meeting at a barrier, a block at a
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
extern "C" void k11(const int* u, const int* v, const int* consts, const short* prog,
                    int* out, int prog_len, long long n) {
  std::barrier<> block(64);
  g_block = &block;
  for (long long b = 0; b < n; ++b) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < 64; ++t)
      ts.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {(unsigned)b, 0, 0};
        comb_kernel((const int4*)u, (const int4*)v, (const int4*)consts,
                    (const int16_t*)prog, (int4*)out, prog_len);
      });
    for (auto& t : ts) t.join();
  }
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """final_exp.cu's kernels (K11's body on coop.cuh) built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("comb_host")
    src = (CSRC / "final_exp.cu").read_text()
    (out / "final_exp_kernels.inc").write_text(_without_launches(src[:src.index('extern "C"')]))
    (out / "coop.cuh").write_text(_without_launches((CSRC / "coop.cuh").read_text()))
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libcomb_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(out),
         "-I", str(CSRC), "-include", str(out / "shim.h"), "-o", str(lib),
         str(out / "harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "c++20" in proc.stderr:
        pytest.skip(f"{cxx} has no C++20 (std::barrier): {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(lib))
    h.k11.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong]
    return h


@pytest.mark.parametrize("mode", tc.COMB_MODES)
def test_comb_kernel_body_matches_plan(host_lib, miller_outputs, mode):  # noqa: F811
    """K11's body (the plan's loads, its one program, the stores) limb for
    limb equal to coop.comb_steps and comb_plain, on Miller outputs
    against seeded values (f = 1 among the u)."""
    u = torch.cat([miller_outputs, _fp12(12, 1)]).contiguous()
    v = _fp12(13, 3)
    prog = coop.to_device(coop.comb_plan(mode), "cpu")
    consts = coop.easy_exp_consts("cpu")
    out = torch.zeros_like(u)
    harness_call(lambda: host_lib.k11(*(ctypes.c_void_p(t.data_ptr())
                                        for t in (u, v, consts, prog, out)),
                                      prog.numel(), u.shape[0]), out)
    assert torch.equal(out, coop.comb_steps(u, v, mode))
    assert torch.equal(out, tc.comb_plain(u, v, mode))


def test_comb_kernel_is_a_block_program():
    """K11 runs coop.cuh's run_lane on one block of kCoopThreads per lane
    (no inversion step), its entry launches through coop::launch, and no
    one-thread body is left beside it."""
    src = (CSRC / "final_exp.cu").read_text()
    assert re.search(r"comb_kernel\(.*?\{\s*coop::run_lane\(prog, prog_len, "
                     r"coop::Inputs\{\{u, v, consts\}\}", src, re.S)
    assert "coop::launch(comb_kernel, n, smem_bytes" in src
    assert "kLaneThreads" not in src and "frobenius(b)" not in src
