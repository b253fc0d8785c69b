"""K5 (the MSM's bucket accumulation) and K6 (its bucket tree) built with the
host C++ compiler and run on the CPU, in their launch shapes, against their
plain versions and K5's segment model; and the segment model itself on the
CPU.

``csrc/msm.cu`` runs each bucket on groups of 8 of a warp's threads with
the group law of ``csrc/warp_curve.cuh``, cut into k segments of its
valid rounds, each on its own group, whose sums the block joins by the
complete addition on half-warps in a tree. Here a block's threads are
``std::thread``s, ``__syncwarp(mask)`` a barrier of the mask's threads of
the thread's warp and ``__syncthreads()`` a barrier of the block, so this
checks the kernel body limb for limb: against ``msm.accum_plain`` unsplit
(k = 1), against ``msm.accum_segments_plain`` split, against
``accum_plain`` at canonical affine in every shape; on seeded schedules
with a duplicate signature (the mixed addition doubles) and a cancelling
pair (a bucket at infinity takes a further point), on masks that are no
prefix, with every set skipped, and the pad lanes; an index outside
[0, S) in a slot the mask skips still stops the kernel; the shape the
launch takes for L rounds. K6 runs one block per window, each of the
window's 16 lanes on a group of 16 threads of the complete addition; it
is checked limb for limb on all 256 lanes against ``msm.tree_plain``, on
two seeded schedules' buckets and on buckets that take every leg of the
addition. Each call into the host build runs under the time limit of
``harness_call``. What it cannot check is the PTX branch of
the carry words and the card's scheduling: ``chip_smoke.py`` and the
``cuda`` tests of ``tests/test_torch_kernels.py`` do, on the card.

The build skips where no host C++ compiler with C++20 is found.
"""

import ctypes
import faulthandler
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import tree_edge_buckets
from lighthouse_tpu_torch.crypto.bls.curve import g2_generator
from lighthouse_tpu_torch.ops import msm, points
from tests.test_torch_curve_host import _function, _kernels_only
from tests.test_torch_htc_host import SHIM, harness_call

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"

# One block at a time of up to 8 warps: a barrier for each group of 4, 8,
# 16 or 32 consecutive threads of each warp that a __syncwarp mask names,
# one for the block's __syncthreads; the CUDA runtime calls of the launch
# paths (not run here). msm.cu's K7 compiles beside K5 and K6 but runs in
# tests/test_torch_curve_host.py.
BLOCK_HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
thread_local Dim threadIdx, blockIdx;
Dim blockDim = {32, 1, 1};
enum cudaError_t { cudaSuccess, cudaErrorInvalidValue };
inline int cudaGetLastError() { return 0; }
// the group of size 4 << s starting at lane 4 k of warp w is g_sync[w][s][k]
static std::barrier<>* g_sync[8][4][8];
static std::barrier<>* g_block;
void __syncwarp(unsigned mask) {
  const int size = __builtin_popcount(mask), first = __builtin_ctz(mask);
  const int s = __builtin_ctz(size) - 2;
  if (size < 4 || size & (size - 1) || first % size ||
      mask != (size == 32 ? 0xffffffffu : ((1u << size) - 1) << first) ||
      !(mask >> (threadIdx.x % 32) & 1))
    abort();
  g_sync[threadIdx.x / 32][s][first / 4]->arrive_and_wait();
}
void __syncthreads() { g_block->arrive_and_wait(); }
#undef __launch_bounds__
#define __launch_bounds__(...)
#include "msm_kernels.inc"

template <class F>
static void blocks(long long first, long long nb, unsigned threads, F f) {
  blockDim = {threads, 1, 1};
  for (unsigned w = 0; w < threads / 32; ++w)
    for (int s = 0; s < 4; ++s)
      for (int k = 0; k < 8; k += 1 << s) {
        delete g_sync[w][s][k];
        g_sync[w][s][k] = new std::barrier<>(4 << s);
      }
  delete g_block;
  g_block = new std::barrier<>(threads);
  for (long long b = first; b < first + nb; ++b) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < threads; ++t)
      ts.emplace_back([=] { threadIdx = {t, 0, 0}; blockIdx = {(unsigned)b, 0, 0}; f(); });
    for (auto& t : ts) t.join();
  }
}
// K5 at k segments, as accum_launch shapes it: its blocks first .. first
// + count - 1 (count -1: all)
extern "C" void k5(int k, const int* sx, const int* sy, const int* idx,
                   const unsigned char* valid, int* oX, int* oY, int* oZ, int L,
                   int S, int first, int count) {
  const unsigned t = kPackedGroup * k > 32 ? kPackedGroup * k : 32;
  const long long nb = count < 0 ? 256LL * kPackedGroup * k / t : count;
  blocks(first, nb, t, [=] {
    msm_accum_kernel((const int4*)sx, (const int4*)sy, idx, valid, (int4*)oX,
                     (int4*)oY, (int4*)oZ, L, S, k);
  });
}
// the segments the launch path takes for L rounds
extern "C" int k5_segments(int L) { return accum_segments(L); }
// K6 as lh_msm_tree launches it: a block per window
extern "C" void k6(const int* bX, const int* bY, const int* bZ, int* oX, int* oY,
                   int* oZ) {
  blocks(0, kWindows, kWindowLanes * kTreeThreads, [=] {
    msm_tree_kernel((const int4*)bX, (const int4*)bY, (const int4*)bZ, (int4*)oX,
                    (int4*)oY, (int4*)oZ);
  });
}
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """msm.cu's kernels (K5's and K6's bodies on warp_curve.cuh) built for
    the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("msm_host")
    (out / "msm_kernels.inc").write_text(_kernels_only((CSRC / "msm.cu").read_text()))
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    (out / "harness.cpp").write_text(BLOCK_HARNESS)
    lib = out / "libmsm_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(out),
         "-I", str(CSRC), "-include", str(out / "shim.h"), "-o", str(lib),
         str(out / "harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "c++20" in proc.stderr:
        pytest.skip(f"{cxx} has no C++20 (std::barrier): {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(lib))
    h.k5.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4
    h.k5_segments.argtypes = [ctypes.c_int]
    h.k6.argtypes = [ctypes.c_void_p] * 6
    return h


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _points(seed, n):
    """n seeded signatures-like points of G2 with the edge cases: set 1
    repeats set 0 and set 3 is -set 2. Returns (sx, sy) int32 [n, 2, 48]."""
    g = g2_generator()
    rng = np.random.default_rng(seed)
    pts = [g.mul(int(k)) for k in rng.integers(2, 1 << 30, n)]
    pts[1] = pts[0]
    pts[3] = pts[2].neg()
    sx, sy, _ = points.g2_to_dev(pts)
    return _t(sx, sy)


def _edge_scalars(seed, n):
    """Seeded scalars where sets 0 and 1 share window 0's digit (the mixed
    addition doubles) and sets 2, 3 and 4 window 1's (the bucket cancels
    to infinity, then takes a further point)."""
    r = np.frombuffer(np.random.default_rng(seed).bytes(8 * n), np.uint64).copy()
    low = np.uint64(0xFF)
    r[0] = (r[0] & ~low) | np.uint64(0x35)
    r[1] = (r[1] & ~low) | np.uint64(0x45)
    for i in (2, 3, 4):
        r[i] = (r[i] & ~low) | np.uint64(0x70 + i)
    return r | np.uint64(1 << 63)


def _schedule(seed, n, skip=None):
    idx, valid = msm.build_schedule(_edge_scalars(seed, n), msm.max_rounds(n), skip)
    return _t(idx, valid)


def _k5(host_lib, k, sx, sy, idx, valid, first=0, count=-1):
    """K5's output lanes, all 256 or those of blocks first .. first +
    count - 1 (the others stay zero)."""
    out = torch.zeros(3, 256, 2, 48, dtype=torch.int32)
    idx, valid = idx.contiguous(), valid.contiguous()
    harness_call(lambda: host_lib.k5(k, *(_ptr(t) for t in (sx, sy, idx, valid)),
                                     _ptr(out[0]), _ptr(out[1]), _ptr(out[2]),
                                     idx.shape[0], sx.shape[0], first, count), out)
    return tuple(out)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _same_points(P, Q):
    """Lane for lane the same point: both at infinity, or X1 Z2^2 = X2 Z1^2
    and Y1 Z2^3 = Y2 Z1^3 with both Z nonzero (canonical affine equality
    without an inversion per lane)."""
    F = points.FP2_OPS
    (X1, Y1, Z1), (X2, Y2, Z2) = P, Q
    a1, a2 = F.sqr(Z1), F.sqr(Z2)
    b1, b2 = F.mul(a1, Z1), F.mul(a2, Z2)
    inf1, inf2 = F.is_zero(Z1), F.is_zero(Z2)
    same = F.eq(F.mul(X1, a2), F.mul(X2, a1)) & F.eq(F.mul(Y1, b2), F.mul(Y2, b1))
    return bool(torch.where(inf1 | inf2, inf1 == inf2, same).all())


# --------------------------------------------------------- the segment model


@pytest.mark.parametrize("seed, n", [(1, 12), (2, 24)])
def test_segment_model_is_accum_plain_at_canonical_affine(seed, n):
    """accum_segments_plain: limb for limb accum_plain at k = 1; the same
    points at canonical affine for k = 2, 4, 8 and 32 (segments emptier
    than the buckets' counts among them), on seeded schedules with the
    edge cases."""
    sx, sy = _points(seed, n)
    idx, valid = _schedule(seed, n)
    want = msm.accum_plain(sx, sy, idx, valid)
    assert _same(msm.accum_segments_plain(sx, sy, idx, valid, 1), want)
    for k in (2, 4, 8, 32):
        assert _same_points(msm.accum_segments_plain(sx, sy, idx, valid, k), want), k


def test_segment_bounds_cut_each_bucket():
    """segment_bounds on a mask that is no prefix: the segments cut [0, L)
    into k runs per lane, each run holds its ``want`` valid rounds, the
    counts differ by at most one, and a lane without valid rounds lies
    wholly in the last segment."""
    rng = np.random.default_rng(3)
    valid = torch.from_numpy(rng.random((20, 240)) < 0.4)
    valid[:, 7] = False
    pad = torch.zeros(20, 16, dtype=torch.bool)
    v = torch.cat([valid, pad], 1)
    for k in (1, 2, 4, 8):
        r0, r1, want = msm.segment_bounds(valid, k)
        assert torch.equal(r0[0], torch.zeros(256, dtype=torch.long))
        assert torch.equal(r1[-1], torch.full((256,), 20))
        assert torch.equal(r1[:-1], r0[1:])
        assert bool((r0 <= r1).all())
        for j in range(k):
            for b in (0, 7, 100, 239, 250):
                assert int(v[r0[j, b]:r1[j, b], b].sum()) == int(want[j, b])
        assert int((want.max(0).values - want.min(0).values).max()) <= 1
        assert bool((r1[:-1, 7] == 0).all())


# ----------------------------------------------------------- the kernel body


@pytest.mark.parametrize("seed, n", [(4, 24), (10, 16)])
def test_accum_unsplit_matches_plain(host_lib, seed, n):
    """K5 with one segment per bucket: limb for limb accum_plain on seeded
    schedules with a doubling, a cancelling pair and a skipped set, pad
    lanes included."""
    sx, sy = _points(seed, n)
    idx, valid = _schedule(seed, n, skip=np.arange(n) == n - 1)
    got = _k5(host_lib, 1, sx, sy, idx, valid)
    assert _same(got, msm.accum_plain(sx, sy, idx, valid))


@pytest.mark.parametrize("k", [2, 4, 8, 16, 32])
def test_accum_segments_match_model(host_lib, k):
    """K5 cut into k segments joined on half-warps: limb for limb
    accum_segments_plain, and accum_plain at canonical affine. The blocks
    of 128 and 256 threads (4 and 8 warps, one bucket each) run on 12
    buckets and the first 4 pad lanes."""
    sx, sy = _points(5, 24)
    idx, valid = _schedule(5, 24)
    lanes = slice(None)
    if k >= 16:
        first, count = 232, 12
        got = _k5(host_lib, k, sx, sy, idx, valid, first, count)
        lanes = slice(first, first + count)
    else:
        got = _k5(host_lib, k, sx, sy, idx, valid)
    model = msm.accum_segments_plain(sx, sy, idx, valid, k)
    assert _same((c[lanes] for c in got), (c[lanes] for c in model))
    want = msm.accum_plain(sx, sy, idx, valid)
    assert _same_points(tuple(c[lanes] for c in got), tuple(c[lanes] for c in want))
    assert not _same(model, want)  # the segments' representatives differ


@pytest.mark.parametrize("k", [1, 4])
def test_accum_any_mask(host_lib, k):
    """A mask that is no prefix, with seeded indices: the kernel skips
    the rounds between valid ones (the plain version's skipped round sets
    a sum at infinity to its point under Z = 0, which the next valid round
    replaces) and gives its model's limbs."""
    rng = np.random.default_rng(6)
    sx, sy = _points(6, 10)
    L = 14
    idx = torch.from_numpy(rng.integers(0, 10, (L, 240), dtype=np.int32))
    valid = torch.from_numpy(rng.random((L, 240)) < 0.3)
    valid[:5, :8] = False  # buckets at infinity through their first rounds
    got = _k5(host_lib, k, sx, sy, idx, valid)
    assert _same(got, msm.accum_segments_plain(sx, sy, idx, valid, k))
    if k == 1:
        assert _same(got, msm.accum_plain(sx, sy, idx, valid))


@pytest.mark.parametrize("k", [1, 2])
def test_accum_cancels_on_a_segments_last_round(host_lib, k):
    """A sum that cancels to infinity on its segment's last round keeps the
    addition's limbs (X3, Y3, 0): bucket 0 adds S and -S on rounds 0 and
    L - 1 (unsplit: its last round), bucket 1 S, -S, then a third point,
    on rounds 1, 2 and 4 (2 segments: the first ends at round 2)."""
    sx, sy = _points(9, 8)
    L = 6
    idx = torch.zeros(L, 240, dtype=torch.int32)
    valid = torch.zeros(L, 240, dtype=torch.bool)
    for b, rounds, sets in ((0, (0, 5), (2, 3)), (1, (1, 2, 4), (2, 3, 5))):
        for r, i in zip(rounds, sets):
            idx[r, b], valid[r, b] = i, True
    idx[:, 2:] = 6  # the other buckets: skipped rounds
    got = _k5(host_lib, k, sx, sy, idx, valid)
    want = msm.accum_segments_plain(sx, sy, idx, valid, k)
    assert _same(got, want)
    assert bool(points.FP2_OPS.is_zero(want[2][0]))  # bucket 0 at infinity,
    assert not torch.equal(want[0][0], sx[3])  # with the addition's X3, not -S's x


@pytest.mark.parametrize("k, L", [(1, 16), (8, 16), (4, 0)])
def test_accum_every_set_skipped(host_lib, k, L):
    """Every set skipped (and no rounds at all): every lane at infinity,
    limb for limb the plain version's (a bucket takes its last round's
    point under Z = 0, a pad lane the all-zero point; with no rounds,
    pt_infinity's (one, one, zero))."""
    sx, sy = _points(7, 8)
    idx, valid = _t(np.zeros((L, 240), np.int32), np.zeros((L, 240), bool))
    got = _k5(host_lib, k, sx, sy, idx, valid)
    want = msm.accum_plain(sx, sy, idx, valid)
    assert _same(got, want)
    assert not bool(got[2].any())
    if L == 0:
        assert _same(got, points.pt_infinity(points.FP2_OPS, (256,), "cpu"))


def test_accum_index_outside_stops_the_kernel(host_lib):
    """An index outside [0, S) in a slot whose round is skipped still
    stops the kernel (__trap; the plain version's IndexError)."""
    sx, sy = _points(8, 8)
    idx, valid = _schedule(8, 8)
    idx = idx.clone()
    row = int(valid[:, 0].sum())  # bucket 0's first skipped round
    idx[row, 0] = 8
    faulthandler.disable()  # the child's abort is the expected outcome
    try:
        with pytest.raises(pytest.fail.Exception, match="died"):
            _k5(host_lib, 2, sx, sy, idx, valid)
    finally:
        faulthandler.enable()


def test_accum_shape_follows_the_rounds(host_lib):
    """The launch's segments for L rounds: 16 up to 256 rounds, 32 past
    that: the schedule's L at 128, 512, 2048, 4096 and 8192 sets is 48, 88,
    208, 368 and 664."""
    assert [msm.max_rounds(s) for s in (128, 512, 2048, 4096, 8192)] == [
        48, 88, 208, 368, 664]
    got = harness_call(lambda: [host_lib.k5_segments(L)
                                for L in (0, 32, 48, 88, 208, 256, 257, 368, 664)])
    assert got == [16] * 6 + [32] * 3


def test_k5_runs_on_the_warp_group_law():
    """K5's groups run warp_curve.cuh's mixed addition, its joins the
    complete addition on half-warps, on groups of 8 threads; the launch's
    entry points take accum_segments' segments; its blocks stay within 256
    threads."""
    src = (CSRC / "msm.cu").read_text()
    k5 = _function(src, "msm_accum_kernel")
    assert "__launch_bounds__(kAccumThreads)" in k5
    assert "block_group<kPackedGroup>(slots)" in k5 and "block_group<kJoinThreads>(slots)" in k5
    assert "pt_add(H, " in k5 and "__syncthreads()" in k5
    assert "pt_add_mixed(G, acc, x, y, false)" in src
    assert re.search(r"constexpr int kAccumThreads = 256;", src)
    assert "if (segments == 0) segments = accum_segments(L);" in src
    assert re.search(r"msm_accum_kernel<<<kLanes \* kPackedGroup \* k / threads, threads, ", src)
    assert not re.search(r"msm_accum_kernel<\w", src)  # one group width


# ------------------------------------------------------------------- K6


def _lane(w, j):
    """The bucket lane of window w's row j (digit j + 1; j = 15 the pad)."""
    return j * 16 + w


def _schedule_buckets(seed, n, skip):
    """K5's plain output on a seeded schedule of n sets with the edge cases:
    buckets of one or several points, empty buckets at (one, one, zero) or
    a point's limbs under Z = 0, the all-zero pad lanes."""
    sx, sy = _points(seed, n)
    idx, valid = _schedule(seed, n, skip)
    return tuple(c.contiguous() for c in msm.accum_plain(sx, sy, idx, valid))


def _window_rows(rows):
    """Bucket lanes whose row j of every window holds rows[j] (a G2 point,
    or None: a point's limbs under Z = 0); the pad lanes all-zero limbs."""
    g = g2_generator()
    F = points.FP2_OPS
    x, y, _ = points.g2_to_dev([p or g for p in rows for _ in range(16)])
    X, Y, Z = (c.clone() for c in points.pt_from_affine(
        F, torch.from_numpy(x), torch.from_numpy(y)))
    for j, p in enumerate(rows):
        if p is None:
            Z[j * 16:(j + 1) * 16] = 0
    pad = torch.zeros(16, 2, 48, dtype=torch.int32)
    return tuple(torch.cat([c, pad]).contiguous() for c in (X, Y, Z))


def _tree_buckets(case):
    g = g2_generator()
    if case == "seeded schedule":
        return _schedule_buckets(12, 24, np.arange(24) == 23)
    if case == "second seeded schedule":
        return _schedule_buckets(5, 40, None)
    if case == "edge lanes":
        return tree_edge_buckets(torch)
    if case == "every lane at infinity":
        return tuple(torch.zeros(256, 2, 48, dtype=torch.int32) for _ in range(3))
    if case == "top digit only":
        return _window_rows([None] * 14 + [g.mul(9)])
    assert case == "one point on every row"
    return _window_rows([g.mul(5)] * 15)


def _k6(host_lib, B):
    out = torch.zeros(3, 256, 2, 48, dtype=torch.int32)
    harness_call(lambda: host_lib.k6(*(_ptr(c) for c in B), _ptr(out[0]),
                                     _ptr(out[1]), _ptr(out[2])), out)
    return tuple(out)


@pytest.mark.parametrize("buckets", [
    "seeded schedule", "second seeded schedule", "edge lanes", "every lane at infinity",
    "top digit only", "one point on every row"])
def test_tree_matches_plain_on_every_lane(host_lib, buckets):
    """K6 limb for limb tree_plain on all 256 lanes: on two seeded
    schedules' buckets; on the edge lanes (a window wholly at infinity,
    buckets at infinity, the doubling, the cancellation); with every lane at
    infinity (each group leaves every step at once); with only digit 15's
    row finite (the lanes below take its point, the row itself the zeros
    shifted in past the window's top); with one point on every row (every
    lane doubles in the first step)."""
    B = _tree_buckets(buckets)
    want = msm.tree_plain(B)
    assert _same(_k6(host_lib, B), want)
    F = points.FP2_OPS
    if buckets == "edge lanes":
        assert bool(F.is_zero(want[2][_lane(0, 0)]))  # window 0's sum at infinity
        assert not bool(F.is_zero(want[2][_lane(2, 0)]))  # window 2's finite
    if buckets == "top digit only":  # window sum 15 * [9] G
        assert _same_points(tuple(c[:16] for c in want),
                            tuple(c[:16] for c in _window_rows([g2_generator().mul(135)])))
    if buckets == "one point on every row":  # (1 + .. + 15) * [5] G
        assert _same_points(tuple(c[:16] for c in want),
                            tuple(c[:16] for c in _window_rows([g2_generator().mul(600)])))


def test_k6_runs_one_block_per_window_on_the_warp_group_law(host_lib):
    """K6's lanes run warp_curve.cuh's complete addition on block groups of
    16 threads, the widest round's 12 products in one pass; one block per
    window of 16 lanes; no dynamic shared memory and no one-thread group
    law left in msm.cu."""
    src = (CSRC / "msm.cu").read_text()
    k6 = _function(src, "msm_tree_kernel")
    assert "__launch_bounds__(kWindowLanes * kTreeThreads)" in k6
    assert "block_group<kTreeThreads>(slots)" in k6
    assert "pt_add(G, P, Q)" in k6 and "__syncthreads()" in k6
    assert re.search(r"constexpr int kTreeThreads = 16;", src)
    assert re.search(r"msm_tree_kernel<<<kWindows, kWindowLanes \* kTreeThreads, 0, ", src)
    assert "extern __shared__" not in src and '#include "curve.cuh"' not in src
    assert "kPasses" not in (CSRC / "warp_curve.cuh").read_text()
