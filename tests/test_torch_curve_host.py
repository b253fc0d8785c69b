"""K3 (scalar multiplication) and K7 (the MSM's Horner pass) built with the
host C++ compiler and run on the CPU, against the plain versions.

Both run in blocks of one warp on the group law of
``csrc/warp_curve.cuh``: K7 and K3 up to one lane per SM on the whole
warp, K3 past that on groups of 4 (G1) or 8 (G2) threads, several lanes to
a warp. With the stand-in for the CUDA built-ins of
``tests/test_torch_htc_host.py`` a block's 32 threads are ``std::thread``s
and ``__syncwarp(mask)`` is a barrier of the mask's threads, so this checks
the warp bodies (their rounds over Fp and Fp2, the slots they deal products
to, the branches each group takes on a bit or a point at infinity) limb
for limb against ``points.pt_scalar_mul_bits`` and ``msm.horner_plain``,
K3's choice of shape by lane count, and the sources' launch shape: one
warp per block, no block-wide barrier. Each call into the host build runs
under the time limit of ``harness_call``. What it cannot
check is the PTX branch of the carry words and the card's scheduling:
``chip_smoke.py`` and the ``cuda`` tests of ``tests/test_torch_kernels.py``
do, on the card.

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

from chip_smoke import horner_edge_windows
from lighthouse_tpu_torch.crypto.bls.curve import g1_generator, g2_generator
from lighthouse_tpu_torch.ops import msm, points
from tests.test_torch_htc_host import SHIM, harness_call

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"

# Blocks of one warp, one block at a time: 32 threads, and a barrier for
# each group of 4, 8, 16 or 32 consecutive threads that a __syncwarp mask
# names; the CUDA runtime calls of the launch paths (not run here) on a
# card of 132 SMs.
WARP_HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
thread_local Dim threadIdx, blockIdx;
Dim blockDim = {32, 1, 1};
// the CUDA runtime calls of the launch paths (not run here), and lanes.cuh's
// SM count (its CUDA branch)
enum cudaError_t { cudaSuccess, cudaErrorInvalidValue };
inline int cudaGetLastError() { return 0; }
namespace bls {
inline int sm_count(int* sms) {
  *sms = 132;  // an H100 SXM's SMs
  return 0;
}
}  // namespace bls
// a barrier for each group of 4, 8, 16 or 32 consecutive threads: the
// group of size 4 << s starting at thread 4 k is g_sync[s][k]
static std::barrier<>* g_sync[4][8];
void __syncwarp(unsigned mask) {
  const int size = __builtin_popcount(mask), first = __builtin_ctz(mask);
  const int s = __builtin_ctz(size) - 2;
  if (size < 4 || size & (size - 1) || first % size ||
      mask != (size == 32 ? 0xffffffffu : ((1u << size) - 1) << first))
    abort();
  g_sync[s][first / 4]->arrive_and_wait();
}
void __syncthreads() { abort(); }
#undef __launch_bounds__
#define __launch_bounds__(...)

template <class F>
static void warps(long long nb, F f) {
  for (int s = 0; s < 4; ++s)
    for (int k = 0; k < 8; k += 1 << s) {
      delete g_sync[s][k];
      g_sync[s][k] = new std::barrier<>(4 << s);
    }
  for (long long b = 0; b < nb; ++b) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < 32; ++t)
      ts.emplace_back([=] { threadIdx = {t, 0, 0}; blockIdx = {(unsigned)b, 0, 0}; f(); });
    for (auto& t : ts) t.join();
  }
}
"""

# K3 and K7 on the warp harness. msm.cu's K5 and K6 (blocks of several
# warps) compile beside K7 but run in tests/test_torch_msm_host.py.
HARNESS = WARP_HARNESS + r"""
#include "scalar_mul_kernels.inc"
#include "msm_kernels.inc"
template <class F, int kThreadsPerLane>
static void k3(const int* qx, const int* qy, const unsigned char* inf,
               const int* bits, int* oX, int* oY, int* oZ, int nbits,
               long long n) {
  constexpr int per_warp = 32 / kThreadsPerLane;
  warps((n + per_warp - 1) / per_warp, [=] {
    scalar_mul_kernel<F, kThreadsPerLane>((const int4*)qx, (const int4*)qy, inf,
                                          bits, (int4*)oX, (int4*)oY, (int4*)oZ,
                                          nbits, n);
  });
}
// lanes per warp: 1, or the packed shape (G1 8, G2 4)
extern "C" void k3_g1(const int* qx, const int* qy, const unsigned char* inf,
                      const int* bits, int* oX, int* oY, int* oZ, int nbits,
                      long long n, int lanes) {
  if (lanes == 1) k3<bls::Fp, 32>(qx, qy, inf, bits, oX, oY, oZ, nbits, n);
  else if (lanes == 32 / kPackedThreads<bls::Fp>)
    k3<bls::Fp, kPackedThreads<bls::Fp>>(qx, qy, inf, bits, oX, oY, oZ, nbits, n);
  else abort();
}
extern "C" void k3_g2(const int* qx, const int* qy, const unsigned char* inf,
                      const int* bits, int* oX, int* oY, int* oZ, int nbits,
                      long long n, int lanes) {
  if (lanes == 1) k3<bls::Fp2, 32>(qx, qy, inf, bits, oX, oY, oZ, nbits, n);
  else if (lanes == 32 / kPackedThreads<bls::Fp2>)
    k3<bls::Fp2, kPackedThreads<bls::Fp2>>(qx, qy, inf, bits, oX, oY, oZ, nbits, n);
  else abort();
}
// the lanes per warp the launch path chooses for n lanes on 132 SMs
extern "C" int k3_lanes_per_warp(int g2, long long n) {
  int lanes = 0;
  if (g2 ? lanes_per_warp<bls::Fp2>(n, &lanes) : lanes_per_warp<bls::Fp>(n, &lanes))
    abort();
  return lanes;
}
extern "C" void k7(const int* tX, const int* tY, const int* tZ, int* oX,
                   int* oY, int* oZ) {
  warps(1, [=] {
    msm_horner_kernel((const int4*)tX, (const int4*)tY, (const int4*)tZ,
                      (int4*)oX, (int4*)oY, (int4*)oZ);
  });
}
"""


def _kernels_only(src: str) -> str:
    """A kernel source without its C entry points and launch
    configurations (the harness calls the kernels itself)."""
    return re.sub(r"<<<.*?>>>", "", src[:src.index('extern "C"')], flags=re.S)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """scalar_mul.cu's K3 and msm.cu's K7, built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("curve_host")
    for source in ("scalar_mul", "msm"):
        (out / f"{source}_kernels.inc").write_text(
            _kernels_only((CSRC / f"{source}.cu").read_text()))
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libcurve_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(out),
         "-I", str(CSRC), "-include", str(out / "shim.h"), "-o", str(lib),
         str(out / "harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "c++20" in proc.stderr:
        pytest.skip(f"{cxx} has no C++20 (std::barrier): {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(lib))
    for fn in (h.k3_g1, h.k3_g2):
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
    h.k3_lanes_per_warp.argtypes = [ctypes.c_int, ctypes.c_longlong]
    h.k7.argtypes = [ctypes.c_void_p] * 6
    return h


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# ------------------------------------------------------------------- K3


def _edge_scalars(nbits):
    """0, all ones (every step adds), single one bits at the top, above the
    middle and at the bottom, and all ones again on the lane whose base is
    at infinity (INF_LANE)."""
    full = (1 << nbits) - 1
    return [0, full, 1 << (nbits - 1), 1 << (nbits * 5 // 8), 1, full]


INF_LANE = 5


def _k3_lanes(group, nbits, n_seeded, seed):
    """(x, y, inf, bits) of n_seeded seeded lanes, then the edge lanes; the
    base at infinity keeps a real point's limbs."""
    gen, pack = ((g1_generator(), points.g1_to_dev) if group == "g1"
                 else (g2_generator(), points.g2_to_dev))
    rng = np.random.default_rng(seed)
    edges = _edge_scalars(nbits)
    ks = [int(k) for k in rng.integers(1, 1 << 62, n_seeded + len(edges))]
    x, y, inf = pack([gen.mul(k) for k in ks])
    inf[n_seeded + INF_LANE] = True
    scal = [int(k) >> (64 - nbits) for k in rng.integers(0, 1 << 64, n_seeded, dtype=np.uint64)]
    bits = points.scalars_to_bits(scal + edges, nbits)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in (x, y, inf, bits))


def _check_k3(host_lib, group, nbits, n_seeded, lanes):
    """K3 at ``lanes`` lanes per warp on n_seeded seeded lanes and the edge
    lanes, against pt_scalar_mul_bits in the raw limbs."""
    x, y, inf, bits = _k3_lanes(group, nbits, n_seeded, seed=nbits + n_seeded)
    F = points.FP_OPS if group == "g1" else points.FP2_OPS
    n = x.shape[0]
    out = torch.zeros(3, *x.shape, dtype=torch.int32)
    fn = host_lib.k3_g1 if group == "g1" else host_lib.k3_g2
    harness_call(lambda: fn(_ptr(x), _ptr(y), _ptr(inf), _ptr(bits), _ptr(out[0]),
                            _ptr(out[1]), _ptr(out[2]), nbits, n, lanes), out)
    want = points.pt_scalar_mul_bits(F, (x, y), inf, bits)
    for got, w in zip(out, want):
        assert torch.equal(got, w)


@pytest.mark.parametrize("group, nbits, n_seeded", [
    ("g1", 64, 2),
    ("g2", 16, 1),
    ("g2", 64, 1),
])
def test_scalar_mul_warp_body_matches_plain(host_lib, group, nbits, n_seeded):
    """K3 on one warp per lane, raw Jacobian limbs of pt_scalar_mul_bits:
    seeded lanes and the edge lanes (scalar 0, all ones, single one bits, a
    base at infinity); G2 also at 16 bits."""
    _check_k3(host_lib, group, nbits, n_seeded, lanes=1)


@pytest.mark.parametrize("group, nbits, n_seeded, lanes", [
    ("g1", 64, 3, 8),
    ("g2", 16, 3, 4),
    ("g2", 64, 3, 4),
])
def test_scalar_mul_packed_lanes_match_plain(host_lib, group, nbits, n_seeded, lanes):
    """K3 with its lanes packed several to a warp (groups of 4 threads over
    Fp, 8 over Fp2, each on its own __syncwarp mask), raw limbs of
    pt_scalar_mul_bits on the lanes of the one-warp test plus seeded ones:
    a warp's groups disagree on their bits and on their early returns (the
    accumulator or the base at infinity), and the last warp is ragged."""
    assert (n_seeded + len(_edge_scalars(nbits))) % lanes
    _check_k3(host_lib, group, nbits, n_seeded, lanes)


def test_lanes_per_warp_follows_the_lane_count(host_lib):
    """One warp per lane while every lane can have an SM of its own (132
    on the harness's stand-in), packed past that: 8 lanes per warp for G1,
    4 for G2."""
    for g2, packed in ((0, 8), (1, 4)):
        assert harness_call(lambda: [host_lib.k3_lanes_per_warp(g2, n)
                                     for n in (1, 128, 132, 133, 2048)]) == [
            1, 1, 1, packed, packed]


# ------------------------------------------------------------------- K7


def _tree_output(seed):
    """The tree output of a small seeded schedule: 8 signatures, seeded
    scalars, L = max_rounds(8)."""
    g = g2_generator()
    rng = np.random.default_rng(seed)
    sx, sy, _ = points.g2_to_dev([g.mul(int(k)) for k in rng.integers(2, 1 << 30, 8)])
    r = np.frombuffer(rng.bytes(64), np.uint64).copy() | np.uint64(1)
    idx, valid = msm.build_schedule(r, msm.max_rounds(8))
    sx, sy, idx, valid = (torch.from_numpy(a) for a in (sx, sy, idx, valid))
    return msm.tree_plain(msm.accum_plain(sx, sy, idx, valid))


@pytest.mark.parametrize("windows", ["tree of a seeded schedule", "edge windows"])
def test_horner_warp_body_matches_plain(host_lib, windows):
    """K7 on one warp, raw limbs of horner_plain: on the tree output of a
    seeded schedule, and on windows that take every leg of the complete
    addition (acc == T[w] doubles, acc == -T[w] cancels, an accumulator
    at infinity takes T[w], a window at infinity keeps acc, two equal
    windows)."""
    T = _tree_output(5) if windows.startswith("tree") else horner_edge_windows(torch)
    T = tuple(c.contiguous() for c in T)
    out = torch.zeros(3, 1, 2, 48, dtype=torch.int32)
    harness_call(lambda: host_lib.k7(*(_ptr(c) for c in T), _ptr(out[0]), _ptr(out[1]),
                                     _ptr(out[2])), out)
    for got, w in zip(out, msm.horner_plain(T)):
        assert torch.equal(got, w)


# ------------------------------------------------------- launch shape


def _function(src: str, name: str) -> str:
    """The text of the function ``name``: from its launch bounds to the
    brace that closes its body."""
    start = src.rindex("__global__", 0, src.index(f"{name}("))
    depth, i = 0, src.index("{", start)
    while True:
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start:i + 1]
        i += 1


def test_k3_and_k7_meet_only_within_a_warp():
    """K3 and K7 run in blocks of one warp on warp_curve.cuh's group law
    (K7 and K3 up to one lane per SM on the whole warp, K3 past that on
    groups of 4 threads over Fp and 8 over Fp2) and synchronise only with
    __syncwarp: no block-wide barrier and no block program on their
    path."""
    law = (CSRC / "warp_curve.cuh").read_text()
    k3_src = (CSRC / "scalar_mul.cu").read_text()
    msm_src = (CSRC / "msm.cu").read_text()
    k3 = _function(k3_src, "scalar_mul_kernel")
    k7 = _function(msm_src, "msm_horner_kernel")
    for text in (law, k3_src, k7):
        assert "__syncthreads" not in text and "coop" not in text
    assert "__syncwarp(G.mask)" in law
    for text, add, group in ((k3, "pt_add_mixed(G, ", "sub_group<kThreadsPerLane>(slots)"),
                             (k7, "pt_add(G, ", "warp_group(slots)")):
        assert "__launch_bounds__(kWarpThreads)" in text
        assert group in text
        assert "pt_double(G, " in text and add in text
    assert "sizeof(F) == sizeof(Fp) ? 4 : 8;" in k3_src
    assert "launch_shape<F, kWarpThreads>(" in k3_src
    assert "launch_shape<F, kPackedThreads<F>>(" in k3_src
    assert re.search(r"scalar_mul_kernel<F, kThreadsPerLane>\s*<<<\(unsigned int\)"
                     r"\(\(n \+ per_warp - 1\) / per_warp\), kWarpThreads, ", k3_src)
    assert re.search(r"msm_horner_kernel<<<1, kWarpThreads, ", msm_src)
