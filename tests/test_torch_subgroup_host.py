"""K4 (the psi-criterion G2 subgroup check) built with the host C++ compiler
and run on the CPU, in each of its three launch shapes, against the plain
version.

``csrc/subgroup_fast.cu`` runs a lane on a group of a warp's threads with
the group law of ``csrc/warp_curve.cuh`` (the whole warp for one lane, or
four lanes per warp on groups of 8 threads) or, past a few packed warps
per SM, one lane per thread. With the warp harness of
``tests/test_torch_curve_host.py`` a block's 32 threads are
``std::thread``s and ``__syncwarp(mask)`` is a barrier of the mask's
threads, so this checks each shape's verdicts against
``points.subgroup_check_g2_fast`` on points in G2, on the curve outside G2
(``map_to_curve_g2`` without cofactor clearing) and at infinity (a lane
whose whole group leaves before its first round), the choice of shape by
lane count, and the source's launch shape. Each call into the host build
runs under the time limit of ``harness_call``. What it cannot check is the
PTX branch of the carry words and the card's scheduling: ``chip_smoke.py``
and the ``cuda`` tests of ``tests/test_torch_kernels.py`` do, on the card.

The build skips where no host C++ compiler with C++20 is found.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.curve import g2_generator
from lighthouse_tpu_torch.crypto.bls.fields import Fq2
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import map_to_curve_g2
from lighthouse_tpu_torch.ops import points
from tests.test_torch_curve_host import WARP_HARNESS, _function, _kernels_only
from tests.test_torch_htc_host import SHIM, harness_call

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"

# K4 on the warp harness; lanes per warp: 1 and 4 on warps, 32 one lane per
# thread (a lane at a time, as blockIdx and threadIdx place it).
HARNESS = WARP_HARNESS + r"""
#include "subgroup_fast_kernels.inc"
template <int kThreadsPerLane>
static void on_warps(const int* qx, const int* qy, const unsigned char* inf,
                     unsigned char* out, long long n) {
  constexpr int per_warp = 32 / kThreadsPerLane;
  warps((n + per_warp - 1) / per_warp, [=] {
    subgroup_fast_warp_kernel<kThreadsPerLane>((const int4*)qx, (const int4*)qy,
                                               inf, out, n);
  });
}
extern "C" void k4(const int* qx, const int* qy, const unsigned char* inf,
                   unsigned char* out, long long n, int lanes) {
  if (lanes == kOneWarp) on_warps<32>(qx, qy, inf, out, n);
  else if (lanes == kPacked) on_warps<32 / kPacked>(qx, qy, inf, out, n);
  else if (lanes == kOneThread) {
    for (long long i = 0; i < n; ++i) {
      blockIdx = {(unsigned)(i / 32), 0, 0};
      threadIdx = {(unsigned)(i % 32), 0, 0};
      subgroup_fast_thread_kernel((const int4*)qx, (const int4*)qy, inf, out, n);
    }
  } else abort();
}
// the lanes per warp the launch path chooses for n lanes on 132 SMs
extern "C" int k4_lanes_per_warp(long long n) {
  int lanes = 0;
  if (lanes_per_warp(n, &lanes)) abort();
  return lanes;
}
"""

SMS = 132  # the harness's stand-in card


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """subgroup_fast.cu's K4 bodies and its shape choice, built for the
    host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("subgroup_host")
    (out / "subgroup_fast_kernels.inc").write_text(
        _kernels_only((CSRC / "subgroup_fast.cu").read_text()))
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libsubgroup_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(out),
         "-I", str(CSRC), "-include", str(out / "shim.h"), "-o", str(lib),
         str(out / "harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "c++20" in proc.stderr:
        pytest.skip(f"{cxx} has no C++20 (std::barrier): {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(lib))
    h.k4.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
    h.k4_lanes_per_warp.argtypes = [ctypes.c_longlong]
    return h


@pytest.fixture(scope="module")
def lanes():
    """(x, y, inf, want): in G2, on the curve outside G2, at infinity (a
    real point's limbs under the flag), in G2, and outside G2 again (the
    packed shape's ragged second warp); want is the plain version's
    verdicts."""
    g = g2_generator()
    pts = [g.mul(3), map_to_curve_g2(Fq2(2, 1)), g.mul(5), g.mul(12345),
           map_to_curve_g2(Fq2(5, 7))]
    x, y, inf = (torch.from_numpy(np.ascontiguousarray(a))
                 for a in points.g2_to_dev(pts))
    inf[2] = True
    want = points.subgroup_check_g2_fast(x, y, inf)
    assert want.tolist() == [True, False, True, True, False]
    return x, y, inf, want


def _k4(host_lib, x, y, inf, lanes_per_warp):
    n = x.shape[0]
    out = torch.full((n,), 7, dtype=torch.uint8)
    harness_call(lambda: host_lib.k4(*(ctypes.c_void_p(t.data_ptr()) for t in (x, y, inf, out)),
                                     n, lanes_per_warp), out)
    return out


@pytest.mark.parametrize("lanes_per_warp, rows", [
    (4, [0, 1, 2, 3, 4]),  # packed: a whole warp, then a ragged one
    (1, [0, 1]),           # one warp per lane: in G2, outside G2
    (1, [2]),              # at infinity: the warp leaves at once
    (32, [0, 1, 2, 3, 4]),  # one thread per lane
])
def test_subgroup_fast_shapes_match_plain(host_lib, lanes, lanes_per_warp, rows):
    """Each shape's verdicts are the plain version's on its lanes."""
    x, y, inf, want = (t[rows].contiguous() for t in lanes)
    got = _k4(host_lib, x, y, inf, lanes_per_warp)
    assert got.tolist() == want.to(torch.uint8).tolist()


def test_lanes_per_warp_follows_the_lane_count(host_lib):
    """One warp per lane up to the source's lanes per SM (on the harness's
    stand-in of 132 SMs), 4 lanes per warp up to its packed warps per SM,
    one lane per thread past that; at the counts of chip_smoke.py's K4
    sweep, the shapes PERF.md found fastest there."""
    src = (CSRC / "subgroup_fast.cu").read_text()
    one_warp, packed = (int(re.search(rf"{name} = (\d+);", src).group(1))
                        for name in ("kOneWarpLanesPerSm", "kPackedWarpsPerSm"))
    edges = (SMS * one_warp, SMS * packed * 4)
    counts = (1, edges[0], edges[0] + 1, edges[1], edges[1] + 1)
    assert harness_call(lambda: [host_lib.k4_lanes_per_warp(n) for n in counts]) == [
        1, 1, 4, 4, 32]
    sweep = (128, 256, 384, 512, 1024, 2048, 4096, 6144, 8192)
    assert harness_call(lambda: [host_lib.k4_lanes_per_warp(n) for n in sweep]) == [
        1, 1, 1, 4, 4, 4, 4, 4, 32]


def test_k4_warp_shapes_meet_only_within_a_warp():
    """K4's warp shapes run in blocks of one warp on warp_curve.cuh's group
    law (the doubling, the mixed addition) and synchronise only with
    __syncwarp; the packed groups hold 8 threads, the widest round's
    products."""
    src = (CSRC / "subgroup_fast.cu").read_text()
    body = _function(src, "subgroup_fast_warp_kernel")
    assert '#include "warp_curve.cuh"' in src
    assert "__syncthreads" not in src and "coop" not in src
    assert "__launch_bounds__(kWarpThreads)" in body
    assert "sub_group<kThreadsPerLane>(slots)" in body
    assert "pt_double(G, " in body and "pt_add_mixed(G, " in body
    assert "launch_warps<kWarpThreads / kPacked>(" in src
    assert re.search(r"constexpr int kPacked = 4;", src)
    assert re.search(r"subgroup_fast_warp_kernel<kThreadsPerLane>\s*<<<\(unsigned int\)"
                     r"\(\(n \+ per_warp - 1\) / per_warp\), kWarpThreads, ", src)
