"""K4 (the psi-criterion G2 subgroup check) and K15 (the full-order check
on the NAF of r) built with the host C++ compiler and run on the CPU, in
each of their three launch shapes, against their plain versions.

``csrc/subgroup_fast.cu`` runs a lane on a group of a warp's threads with
the group law of ``csrc/warp_curve.cuh`` (the whole warp for one lane, or
four lanes per warp on groups of 8 threads) or, past a few packed warps
per SM, one lane per thread; K4 and K15 differ only in the chain a lane
runs. With the warp harness of ``tests/test_torch_curve_host.py`` a
block's 32 threads are ``std::thread``s and ``__syncwarp(mask)`` is a
barrier of the mask's threads, so this checks each shape's verdicts
against ``points.subgroup_check_g2_fast`` (K4) and
``points.pt_subgroup_check`` (K15) on points in G2, on the curve outside
G2 (``map_to_curve_g2`` without cofactor clearing) and at infinity (a lane
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

# K4 and K15 on the warp harness; lanes per warp: 1 and 4 on warps, 32 one
# lane per thread (a lane at a time, as blockIdx and threadIdx place it).
HARNESS = WARP_HARNESS + r"""
#include "subgroup_fast_kernels.inc"
template <class Check, int kThreadsPerLane>
static void on_warps(const int* qx, const int* qy, const unsigned char* inf,
                     unsigned char* out, long long n) {
  constexpr int per_warp = 32 / kThreadsPerLane;
  warps((n + per_warp - 1) / per_warp, [=] {
    subgroup_warp_kernel<Check, kThreadsPerLane>((const int4*)qx, (const int4*)qy,
                                                 inf, out, n);
  });
}
template <class Check>
static void check(const int* qx, const int* qy, const unsigned char* inf,
                  unsigned char* out, long long n, int lanes) {
  if (lanes == kOneWarp) on_warps<Check, 32>(qx, qy, inf, out, n);
  else if (lanes == kPacked) on_warps<Check, 32 / kPacked>(qx, qy, inf, out, n);
  else if (lanes == kOneThread) {
    for (long long i = 0; i < n; ++i) {
      blockIdx = {(unsigned)(i / 32), 0, 0};
      threadIdx = {(unsigned)(i % 32), 0, 0};
      subgroup_thread_kernel<Check>((const int4*)qx, (const int4*)qy, inf, out, n);
    }
  } else abort();
}
extern "C" void k4(const int* qx, const int* qy, const unsigned char* inf,
                   unsigned char* out, long long n, int lanes) {
  check<PsiCheck>(qx, qy, inf, out, n, lanes);
}
extern "C" void k15(const int* qx, const int* qy, const unsigned char* inf,
                    unsigned char* out, long long n, int lanes) {
  check<OrderCheck>(qx, qy, inf, out, n, lanes);
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
    """subgroup_fast.cu's K4 and K15 bodies and its shape choice, built for
    the host."""
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
    for fn in (h.k4, h.k15):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int]
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


def _k4(host_lib, x, y, inf, lanes_per_warp, fn="k4"):
    n = x.shape[0]
    out = torch.full((n,), 7, dtype=torch.uint8)
    call = getattr(host_lib, fn)
    harness_call(lambda: call(*(ctypes.c_void_p(t.data_ptr()) for t in (x, y, inf, out)),
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


def test_subgroup_full_shapes_match_plain(host_lib, lanes):
    """K15 (the NAF of r, its last mixed addition landing on -Q + Q for a
    point in G2) in each shape: the verdicts of its plain version, the
    binary chain of pt_subgroup_check, on the lanes of ``lanes`` (the same
    membership as K4's). One test for the three shapes, so that the plain
    version runs once."""
    x, y, inf, want = lanes
    F = points.FP2_OPS
    full = points.pt_subgroup_check(F, points.pt_from_affine(F, x, y, inf))
    assert torch.equal(full, want)
    for lanes_per_warp, rows in (
            (4, [0, 1, 2, 3, 4]),   # packed: a whole warp, then a ragged one
            (1, [1, 2, 0]),         # one warp per lane: outside G2, at infinity, in G2
            (32, [0, 1, 2, 3, 4])):  # one thread per lane
        got = _k4(host_lib, *(t[rows].contiguous() for t in (x, y, inf)),
                  lanes_per_warp, fn="k15")
        assert got.tolist() == full[rows].to(torch.uint8).tolist(), lanes_per_warp


def _lanes_per_warp(host_lib, sweep):
    """The launch rule's lanes per warp at its crossovers (one warp per lane
    up to the source's lanes per SM on the harness's stand-in of 132 SMs, 4
    lanes per warp up to its packed warps per SM, one lane per thread past
    that) and at the counts of a sweep."""
    src = (CSRC / "subgroup_fast.cu").read_text()
    one_warp, packed = (int(re.search(rf"{name} = (\d+);", src).group(1))
                        for name in ("kOneWarpLanesPerSm", "kPackedWarpsPerSm"))
    edges = (SMS * one_warp, SMS * packed * 4)
    counts = (1, edges[0], edges[0] + 1, edges[1], edges[1] + 1)
    fn = host_lib.k4_lanes_per_warp
    assert harness_call(lambda: [fn(n) for n in counts]) == [1, 1, 4, 4, 32]
    return harness_call(lambda: [fn(n) for n in sweep])


def test_lanes_per_warp_follows_the_lane_count(host_lib):
    """K4: one warp per lane up to 3 lanes per SM, 4 lanes per warp up to 12
    packed warps per SM, one lane per thread past that; at the counts of
    chip_smoke.py's K4 sweep, the shapes PERF.md found fastest there."""
    sweep = (128, 256, 384, 512, 1024, 2048, 4096, 6144, 8192)
    assert _lanes_per_warp(host_lib, sweep) == [1, 1, 1, 4, 4, 4, 4, 4, 32]


def test_k15_lanes_per_warp_follows_the_lane_count(host_lib):
    """K15 takes K4's launch rule (one rule, no limit of its own): its C
    entry chooses by the same lanes_per_warp; at the counts of
    chip_smoke.py's K15 sweep, the shapes that rule gives."""
    src = (CSRC / "subgroup_fast.cu").read_text()
    assert "template <class Check>\nint lanes_per_warp" not in src
    body = src[src.index("int launch("):]
    assert "const int err = lanes_per_warp(n, &lanes);" in body[:body.index("\n}")]
    text = src[src.index('extern "C" int lh_subgroup_full('):]
    assert "launch<OrderCheck>(qx, qy, q_inf, out, 0, n, stream)" in text[:text.index("\n}")]
    assert "lh_subgroup_full_lanes_per_warp" not in src
    sweep = (128, 396, 2048, 6336, 8192)
    assert _lanes_per_warp(host_lib, sweep) == [1, 1, 4, 4, 32]


def test_k4_warp_shapes_meet_only_within_a_warp():
    """K4's and K15's warp shapes run in blocks of one warp on
    warp_curve.cuh's group law (the doubling, the mixed addition) and
    synchronise only with __syncwarp; the packed groups hold 8 threads, the
    widest round's products; both checks take the one launch rule."""
    src = (CSRC / "subgroup_fast.cu").read_text()
    body = _function(src, "subgroup_warp_kernel")
    assert '#include "warp_curve.cuh"' in src
    assert "__syncthreads" not in src and "coop" not in src
    assert "__launch_bounds__(kWarpThreads)" in body
    assert "sub_group<kThreadsPerLane>(slots)" in body and "Check::warp(G, x, y)" in body
    for chain in ("struct PsiCheck", "struct OrderCheck"):
        text = src[src.index(chain):]
        text = text[:text.index("\n};")]
        assert "pt_double(G, " in text and "pt_add_mixed(G, " in text
    assert "launch_warps<Check, kWarpThreads / kPacked>(" in src
    assert re.search(r"constexpr int kPacked = 4;", src)
    assert re.search(r"subgroup_warp_kernel<Check, kThreadsPerLane>\s*<<<\(unsigned int\)"
                     r"\(\(n \+ per_warp - 1\) / per_warp\), kWarpThreads, ", src)
    for entry, check in (("lh_subgroup_fast", "PsiCheck"), ("lh_subgroup_full", "OrderCheck")):
        for name in (entry, f"{entry}_shaped"):
            text = src[src.index(f'extern "C" int {name}('):]
            assert f"launch<{check}>(" in text[:text.index("\n}")]
    assert not (CSRC / "subgroup.cu").exists()  # K15's one-thread source folded in here
