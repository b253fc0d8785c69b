"""K1's tiled kernel and K2's divstep inversion, their CUDA sources built
with the host C++ compiler and run on the CPU, against the plain versions;
and a Python model of the inversion's divstep schedule.

``csrc/mont_mul.cu`` and ``csrc/fp.cuh`` keep a branch for host compilers
(plain copies in place of the TMA bulk copies and their mbarriers, portable
carry words), so they compile here with a stand-in for the CUDA built-ins:
a block's 64 threads are ``std::thread``s and ``__syncthreads`` is a
barrier. This checks K1's tile walk (the persistent grid, both stages, the
ragged last tile, the rotated chunk order) limb for limb against
``mont_mul_plain``, ``fp.cuh``'s divstep inversion against ``pow(x, p - 2,
p)``, and K2 (``csrc/to_affine.cu``, G1 and G2) against
``points.pt_to_affine`` on seeded points and the edge lanes, each call
under the time limit of ``harness_call``. What it cannot
check is the asynchronous copies themselves and the card's scheduling:
``chip_smoke.py`` and the ``cuda`` tests of ``tests/test_torch_kernels.py``
do, on the card.

The builds skip where no host C++ compiler with C++20 is found.
"""

import ctypes
import importlib.util
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
from lighthouse_tpu_torch.crypto.bls.fields import Fq2
from lighthouse_tpu_torch.ops import field, mont_mul, points
from tests.test_torch_htc_host import harness_call

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"
R = 1 << 384
TILE = 64  # mont_mul.cu kTile: products per tile, threads per block

# The CUDA built-ins the sources use, for a host compiler.
SHIM = r"""
#pragma once
#include <stdint.h>
#include <stdlib.h>
#define __device__
#define __host__
#define __global__
#define __constant__
#define __shared__
#define __align__(n) __attribute__((aligned(n)))
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __restrict__
struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
struct Dim { unsigned x, y, z; };
extern thread_local Dim threadIdx, blockIdx;
extern Dim blockDim, gridDim;
void __syncthreads();
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
"""

# K1: one block at a time, 64 threads meeting at a barrier.
K1_HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
thread_local Dim threadIdx, blockIdx;
Dim blockDim = {64, 1, 1}, gridDim = {1, 1, 1};
static std::barrier<>* g_block;
void __syncthreads() { g_block->arrive_and_wait(); }
namespace {
__attribute__((aligned(128))) unsigned char smem[1 << 16];
}
#include "mont_mul_kernels.inc"
extern "C" void k1(const int* a, const int* b, int* out, long long n,
                   unsigned grid) {
  std::barrier<> block(kTile);
  g_block = &block;
  blockDim = {(unsigned)kTile, 1, 1};
  gridDim = {grid, 1, 1};
  for (unsigned g = 0; g < grid; ++g) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < (unsigned)kTile; ++t)
      ts.emplace_back([=] {
        threadIdx = {t, 0, 0};
        blockIdx = {g, 0, 0};
        mont_mul_kernel((const int4*)a, (const int4*)b, (int4*)out, n);
      });
    for (auto& t : ts) t.join();
  }
}
extern "C" int k1_tile() { return kTile; }
extern "C" int k1_smem() { return kSmemBytes; }
"""

# K2: one lane at a time (a lane is one thread and meets no other), and the
# inversion's two layers on words.
K2_HARNESS = r"""
thread_local Dim threadIdx, blockIdx;
Dim blockDim = {32, 1, 1}, gridDim = {1, 1, 1};
void __syncthreads() {}
#include "to_affine_kernels.inc"
template <class F>
static void lanes(const int* X, const int* Y, const int* Z, int* ox, int* oy,
                  unsigned char* inf, long long n) {
  for (long long i = 0; i < n; ++i) {
    blockIdx = {(unsigned)(i / 32), 0, 0};
    threadIdx = {(unsigned)(i % 32), 0, 0};
    to_affine_kernel<F>((const int4*)X, (const int4*)Y, (const int4*)Z,
                        (int4*)ox, (int4*)oy, inf, n);
  }
}
extern "C" void k2_g1(const int* X, const int* Y, const int* Z, int* ox,
                      int* oy, unsigned char* inf, long long n) {
  lanes<bls::Fp>(X, Y, Z, ox, oy, inf, n);
}
extern "C" void k2_g2(const int* X, const int* Y, const int* Z, int* ox,
                      int* oy, unsigned char* inf, long long n) {
  lanes<bls::Fp2>(X, Y, Z, ox, oy, inf, n);
}
extern "C" void inv_words(const uint32_t* a, uint32_t* gcd, uint32_t* mont,
                          int n) {
  for (int i = 0; i < n; ++i) {
    uint32_t c[12];
    fp::fp_canonical(c, a + 12 * i);
    fp::gcd_inverse(gcd + 12 * i, c);
    fp::fp_inv_gcd(mont + 12 * i, a + 12 * i);
  }
}
"""


def _kernels_only(src: str) -> str:
    """A kernel source without its C entry points and launch
    configurations (the host harness calls the kernels itself)."""
    return re.sub(r"<<<.*?>>>", "", src[:src.index('extern "C"')], flags=re.S)


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    """{"k1": mont_mul.cu, "k2": to_affine.cu and fp.cuh's inversion},
    built for the host, the two builds side by side."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("affine_host")
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    procs = {}
    for name, source, harness in (("k1", "mont_mul", K1_HARNESS),
                                  ("k2", "to_affine", K2_HARNESS)):
        (out / f"{source}_kernels.inc").write_text(
            _kernels_only((CSRC / f"{source}.cu").read_text()))
        (out / f"{name}.cpp").write_text(harness)
        lib = out / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread",
             "-I", str(out), "-I", str(CSRC), "-include", str(out / "shim.h"),
             "-o", str(lib), str(out / f"{name}.cpp")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode and "c++20" in err:
            pytest.skip(f"{cxx} has no C++20 (std::barrier): {err[:200]}")
        assert proc.returncode == 0, err
        libs[name] = ctypes.CDLL(str(lib))
    libs["k1"].k1.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_uint]
    for fn in ("k2_g1", "k2_g2"):
        getattr(libs["k2"], fn).argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong]
    libs["k2"].inv_words.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    return libs


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


# ------------------------------------------------------------------- K1


def _operands(n, seed):
    """int32 [n, 48] pairs in [0, 2p), the last rows the edge pairs."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n, 48), dtype=np.int32)
    b = rng.integers(0, 256, size=(n, 48), dtype=np.int32)
    a[:, 47] %= 0x34
    b[:, 47] %= 0x34
    edges = [0, 1, P - 1, P, 2 * P - 1, R % P]
    k = min(n, 6)
    a[n - k:] = field.ints_to_limbs(edges[:k])
    b[n - k:] = field.ints_to_limbs(edges[::-1][:k])
    return torch.from_numpy(a), torch.from_numpy(b)


def test_k1_tile_layout_matches_python(host_libs):
    """The host build's tile is the one this file assumes, and two stages
    of an a and a b tile plus two mbarriers fit the 48 KiB step (4 blocks
    per SM on an H100's 228 KiB)."""
    k1 = host_libs["k1"]
    tile, smem = harness_call(lambda: (k1.k1_tile(), k1.k1_smem()))
    assert tile == TILE
    assert smem == 2 * 2 * TILE * 192 + 16
    assert 4 * (smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("n, grid", [
    (1, 1), (TILE - 1, 1), (TILE + 1, 1), (54, 2),
    # one block walks five tiles through both stages (parity 0, 1, 0)
    (5 * TILE - 3, 1),
    # three blocks walk 2-3 tiles each, the last tile ragged
    (7 * TILE + 5, 3),
    # more blocks than tiles: the spare block runs no tile
    (2 * TILE, 3),
])
def test_tiled_mont_mul_matches_plain(host_libs, n, grid):
    a, b = _operands(n, seed=n)
    out = torch.full((n, 48), -1, dtype=torch.int32)
    harness_call(lambda: host_libs["k1"].k1(_ptr(a), _ptr(b), _ptr(out), n, grid), out)
    assert torch.equal(out, mont_mul.mont_mul_plain(a, b))


# -------------------------------------------------- K2's inversion

BATCH, BATCHES = 30, 37     # fp.cuh kDivstepBatch, kDivstepBatches
BOUND = (49 * 381 + 57) // 17  # Bernstein-Yang Theorem 11.2, d = 381
M30 = (1 << 30) - 1


def _words(x: int):
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(12)]


def _value(w) -> int:
    return sum(int(v) << (32 * k) for k, v in enumerate(w))


def test_divstep_count_and_constants_match_the_source():
    text = (CSRC / "fp.cuh").read_text()
    batch = int(re.search(r"kDivstepBatch = (\d+);", text).group(1))
    batches = int(re.search(r"kDivstepBatches = (\d+);", text).group(1))
    assert (batch, batches) == (BATCH, BATCHES)
    assert BOUND == 1101 and P.bit_length() == 381
    assert batch * batches >= BOUND > batch * (batches - 1)
    body = re.search(r"kP30\[kS30\] = \{(.*?)\};", text, re.S).group(1)
    assert [int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})", body)] == \
        [(P >> (30 * i)) & M30 for i in range(13)]
    # the smoke's operation count for K2's bound reads the same loop counts
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", CSRC.parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert smoke.gcd_inverse_ops() == BATCHES * (BATCH * 29 + 13 * (22 + 30) + 10) + 300
    inv = int(re.search(r"kPInv30 = 0x([0-9a-f]+)u;", text).group(1), 16)
    assert inv * P % (1 << 30) == 1
    body = re.search(r"kR3\[kWords\] = \{(.*?)\};", text, re.S).group(1)
    assert _value([int(w, 16) for w in re.findall(r"0x([0-9a-f]{8})u", body)]) \
        == pow(R, 3, P)


def test_gcd_inverse_matches_fermat(host_libs):
    """gcd_inverse is pow(x, p - 2, p) on [0, p); fp_inv_gcd, on any
    [0, 2p) value, the Montgomery inverse: a result r in [0, 2p) with
    r * a = R^2 mod p (0 -> 0)."""
    rng = random.Random(11)
    xs = [0, 1, 2, P - 1, P - 2, R % P, P, P + 1, 2 * P - 1, (P - 1) // 2]
    xs += [rng.randrange(2 * P) for _ in range(300)]
    a = np.array([_words(x) for x in xs], np.uint32)
    gcd = np.zeros_like(a)
    mont = np.zeros_like(a)
    harness_call(lambda: host_libs["k2"].inv_words(a.ctypes.data, gcd.ctypes.data,
                                                   mont.ctypes.data, len(xs)), gcd, mont)
    for x, g, m in zip(xs, gcd, mont):
        assert _value(g) == pow(x % P, P - 2, P)
        r = _value(m)
        assert r < 2 * P
        assert r * x % P == (R * R % P if x % P else 0)


def _jacobian_g1(n, seed):
    """n seeded G1 points as Jacobian (x z^2, y z^3, z) Montgomery limbs,
    then the edge lanes: Z = 0, Z = p (the lazy zero), Z = Montgomery one,
    Z in [p, 2p), Z = p - 1 (-1: X = x, Y = -y)."""
    rng = random.Random(seed)
    pts = [g1_generator().mul(rng.randrange(1, 1 << 64)) for _ in range(n)]
    X, Y, Z = [], [], []
    for i, p in enumerate(pts):
        x, y = p.x.n, p.y.n
        z = [rng.randrange(1, P), 0, 0, 1, rng.randrange(1, P), P - 1][min(i, 5)]
        X.append(x * z * z % P)
        Y.append(y * z * z * z % P)
        Z.append(z)
    X, Y, Z = (field.ints_to_limbs_mont(v) for v in (X, Y, Z))
    Z[2] = field.ints_to_limbs([P])[0]
    Z[4] = field.ints_to_limbs([field.limbs_to_int(Z[4]) + P])[0]
    return tuple(torch.from_numpy(np.ascontiguousarray(v)) for v in (X, Y, Z))


def _jacobian_g2(n, seed):
    """The same for G2, z in Fq2; the edge lanes on z's c0 (c1 = 0)."""
    rng = random.Random(seed)
    pts = [g2_generator().mul(rng.randrange(1, 1 << 64)) for _ in range(n)]
    coords = []
    for i, p in enumerate(pts):
        z = Fq2(rng.randrange(P), rng.randrange(P))
        z = [z, Fq2(0, 0), Fq2(0, 0), Fq2(1, 0), z, Fq2(P - 1, 0)][min(i, 5)]
        z2 = z * z
        X, Y = p.x * z2, p.y * z2 * z
        coords.append([X.c0, X.c1, Y.c0, Y.c1, z.c0, z.c1])
    limbs = field.ints_to_limbs_mont([v for row in coords for v in row])
    limbs = limbs.reshape(n, 3, 2, 48)
    limbs[2, 2, 0] = field.ints_to_limbs([P])[0]
    limbs[4, 2, 0] = field.ints_to_limbs([field.limbs_to_int(limbs[4, 2, 0]) + P])[0]
    return tuple(torch.from_numpy(np.ascontiguousarray(limbs[:, k])) for k in range(3))


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_to_affine_matches_plain(host_libs, group):
    """K2, one lane per thread with the divstep inversion, raw limbs equal
    to ``pt_to_affine`` (Fermat) on 8 seeded points and the edge lanes."""
    F, make = ((points.FP_OPS, _jacobian_g1) if group == "g1"
               else (points.FP2_OPS, _jacobian_g2))
    J = make(8, seed=3 if group == "g1" else 4)
    n = J[0].shape[0]
    ox, oy = torch.empty_like(J[0]), torch.empty_like(J[0])
    inf = torch.zeros(n, dtype=torch.bool)
    k2 = getattr(host_libs["k2"], f"k2_{group}")
    harness_call(lambda: k2(*(_ptr(t) for t in (*J, ox, oy, inf)), n), ox, oy, inf)
    want = points.pt_to_affine(F, J)
    assert torch.equal(ox, want[0]) and torch.equal(oy, want[1])
    assert torch.equal(inf, want[2])
    assert inf.tolist() == [False, True, True] + [False] * 5


# ------------------------------------ a model of the divstep schedule


def _divsteps(delta, f, g):
    """fp.cuh divsteps_30 on numpy uint32 lanes: 30 divsteps on the low
    bits -> (delta, (u, v, q, r) as Python ints, (q, r) after each step as
    int32)."""
    u, v = np.ones_like(f), np.zeros_like(f)
    q, r = np.zeros_like(f), np.ones_like(f)
    trail = []
    for _ in range(BATCH):
        c1 = np.where(delta > 0, np.uint32(0xFFFFFFFF), np.uint32(0))
        c2 = np.uint32(0) - (g & np.uint32(1))
        x, y, z = (f ^ c1) - c1, (u ^ c1) - c1, (v ^ c1) - c1
        g, q, r = g + (x & c2), q + (y & c2), r + (z & c2)
        c = c1 & c2
        delta = np.where(c != 0, 1 - delta, 1 + delta)
        f, u, v = f + (g & c), u + (q & c), v + (r & c)
        g, u, v = g >> np.uint32(1), u << np.uint32(1), v << np.uint32(1)
        trail.append((q.view(np.int32).copy(), r.view(np.int32).copy()))
    signed = (w.view(np.int32).astype(object) for w in (u, v, q, r))
    return delta, tuple(signed), trail


def test_divstep_schedule_reaches_zero_within_the_bound():
    """The kernel's schedule on Python integers: 37 batches of 30 divsteps
    from delta = 1, each batch's matrix built from the low 30 bits and
    applied exactly. On the edge inputs and 10^4 seeded ones, g reaches 0
    by divstep 1,101 (the cited bound), stays 0, f ends at +-1 (p for the
    input 0), and d * sign(f) is the inverse (0 for 0)."""
    rng = random.Random(12)
    xs = [0, 1, 2, P - 1, P - 2, R % P, (P - 1) // 2, (1 << 380) + 1]
    xs += [rng.randrange(P) for _ in range(10_000)]
    n = len(xs)
    f = np.array([P] * n, dtype=object)
    g = np.array(xs, dtype=object)
    d = np.array([0] * n, dtype=object)
    e = np.array([1] * n, dtype=object)
    delta = np.ones(n, np.int64)
    first = np.where(g == 0, 0, -1)
    inv30 = pow(2, -30, P)

    def low(a):
        return np.array([int(v) & M30 for v in a], np.uint32)

    for b in range(BATCHES):
        delta, (u, v, q, r), trail = _divsteps(delta, low(f), low(g))
        nf, ng = u * f + v * g, q * f + r * g
        assert not any(int(w) & M30 for w in np.concatenate([nf, ng]))
        for i in np.nonzero((first < 0) & (ng == 0))[0]:
            # the step inside this batch where g became 0:
            # q_k f + r_k g = 2^k g_k
            first[i] = b * BATCH + 1 + next(
                k for k, (qk, rk) in enumerate(trail)
                if int(qk[i]) * f[i] + int(rk[i]) * g[i] == 0)
        assert all(ng[first >= 0] == 0)  # once 0, g stays 0
        d, e = (u * d + v * e) * inv30 % P, (q * d + r * e) * inv30 % P
        f, g = nf >> 30, ng >> 30
    assert (first >= 0).all() and first.max() <= BOUND
    assert all(g == 0)
    for x, fi, di in zip(xs, f, d):
        assert fi in (1, -1) if x else fi == P
        assert (di * fi * x) % P == (1 if x else 0) and 0 <= di < P
