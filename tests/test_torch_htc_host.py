"""The hash kernels' CUDA sources built with the host C++ compiler and run
on the CPU, against the plain versions.

``csrc/fp.cuh`` keeps a portable branch of its carry-chain words for host
compilers, so ``csrc/htc.cu`` (on ``htc.cuh``) compiles here with a small
stand-in for the CUDA built-ins: a block's 32 threads are ``std::thread``s
and ``__syncwarp(mask)`` is a barrier of the mask's threads. This checks the
word arithmetic of ``fp_mul`` / ``fp_add`` / ``fp_sub`` against Python
integers, and K12, K13 and K14's warp bodies (their rounds, the slots they
deal products to, the half-warp and whole-warp groups, the branches each
group takes) limb for limb against ``map_to_g2_resident_plain``,
``sswu_iso_plain`` and ``cofactor_plain``. What it cannot check is the PTX
branch of the carry words and the card's scheduling: ``chip_smoke.py`` and
the ``cuda`` tests of ``tests/test_torch_kernels.py`` do, on the card.

The test skips where no host C++ compiler with C++20 is found. Every call
into a host build runs through :func:`harness_call`, in a child process
under a time limit, so a thread stuck at a barrier fails its test instead
of stalling the run.
"""

import ctypes
import multiprocessing
import random
import re
import shutil
import subprocess
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.fields import Fq2
from lighthouse_tpu_torch.ops import htc, tower
from lighthouse_tpu_torch.ops import tkernel_htc as th

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"
R = 1 << 384

# Seconds a host-harness call may take: each takes well under ten here.
HARNESS_SECONDS = 120


def harness_call(call, *outs, seconds=HARNESS_SECONDS):
    """Run ``call()``, a call into a host build that writes into the CPU
    tensors or numpy arrays ``outs``, in a forked child; copy what it wrote
    back and return what it returned. Fails the test when the child runs
    past ``seconds`` (a thread of an emulated warp or block that never
    reaches a barrier waits forever) or dies."""
    ctx = multiprocessing.get_context("fork")
    recv, send = ctx.Pipe(duplex=False)

    def child():
        ret = call()
        send.send((ret, [np.array(o, copy=True) for o in outs]))

    proc = ctx.Process(target=child, daemon=True)
    with warnings.catch_warnings():
        # the child runs only the call and the copy: no lock that another
        # thread of this process may hold
        warnings.simplefilter("ignore", DeprecationWarning)
        proc.start()
    send.close()
    try:
        if not recv.poll(seconds):
            proc.kill()
            proc.join()
            pytest.fail(f"host-harness call still running after {seconds} s "
                        "(a thread stuck at a barrier?)")
        try:
            ret, data = recv.recv()
        except EOFError:
            proc.join()
            pytest.fail(f"host-harness call died (exit code {proc.exitcode})")
    finally:
        recv.close()
    proc.join()
    for o, d in zip(outs, data):
        np.asarray(o)[...] = d
    return ret


# The CUDA built-ins the sources use, for a host compiler.
SHIM = r"""
#pragma once
#include <stdint.h>
#include <stdlib.h>
#define __device__
#define __host__
#define __global__
#define __constant__
#define __shared__ static
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __launch_bounds__(x)
#define __restrict__
struct int4 { int x, y, z, w; };
struct uint4 { unsigned x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
inline uint4 make_uint4(unsigned x, unsigned y, unsigned z, unsigned w) {
  return {x, y, z, w};
}
struct Dim { unsigned x, y, z; };
extern thread_local Dim threadIdx, blockIdx;
extern Dim blockDim;
void __syncwarp(unsigned mask = 0xffffffffu);
inline void __trap() { abort(); }
typedef void* cudaStream_t;
"""

# One block at a time: 32 threads, a barrier per __syncwarp mask.
HARNESS = r"""
#include <barrier>
#include <thread>
#include <vector>
thread_local Dim threadIdx, blockIdx;
Dim blockDim = {32, 1, 1};
static std::barrier<>* g_sync[3];
void __syncwarp(unsigned mask) {
  if (mask == 0xffffffffu) g_sync[0]->arrive_and_wait();
  else if (mask == 0x0000ffffu) g_sync[1]->arrive_and_wait();
  else if (mask == 0xffff0000u) g_sync[2]->arrive_and_wait();
  else abort();
}
#include "htc_kernels.inc"

template <class F>
static void blocks(long long nb, F f) {
  std::barrier<> warp(32), h0(16), h1(16);
  g_sync[0] = &warp; g_sync[1] = &h0; g_sync[2] = &h1;
  for (long long b = 0; b < nb; ++b) {
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < 32; ++t)
      ts.emplace_back([=] { threadIdx = {t, 0, 0}; blockIdx = {(unsigned)b, 0, 0}; f(); });
    for (auto& t : ts) t.join();
  }
}
extern "C" void fp_words(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) {
    fp::fp_mul(out + 36 * i, a + 12 * i, b + 12 * i);
    fp::fp_add(out + 36 * i + 12, a + 12 * i, b + 12 * i);
    fp::fp_sub(out + 36 * i + 24, a + 12 * i, b + 12 * i);
  }
}
extern "C" void k12(const int* us, int* X, int* Y, int* Z, long long n) {
  blocks(n, [=] { map_to_g2_kernel((const int4*)us, (int4*)X, (int4*)Y, (int4*)Z); });
}
extern "C" void k13(const int* u, int* X, int* Y, int* Z, long long n) {
  blocks((n + 1) / 2, [=] { sswu_iso_kernel((const int4*)u, (int4*)X, (int4*)Y, (int4*)Z, n); });
}
extern "C" void k14(const int* X, const int* Y, const int* Z, int* oX, int* oY,
                    int* oZ, long long n) {
  blocks(n, [=] {
    cofactor_kernel((const int4*)X, (const int4*)Y, (const int4*)Z, (int4*)oX,
                    (int4*)oY, (int4*)oZ);
  });
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """htc.cu's kernels and fp.cuh's words, built for the host."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the CUDA sources with")
    out = tmp_path_factory.mktemp("htc_host")
    src = (CSRC / "htc.cu").read_text()
    # the kernels without their launching entry points (<<<...>>>)
    (out / "htc_kernels.inc").write_text(src[:src.index('extern "C"')])
    (out / "shim.h").write_text(SHIM)
    (out / "cuda_runtime.h").write_text("")
    (out / "harness.cpp").write_text(HARNESS)
    lib = out / "libhtc_host.so"
    proc = subprocess.run(
        [cxx, "-O1", "-std=c++20", "-shared", "-fPIC", "-pthread", "-I", str(out),
         "-I", str(CSRC), "-include", str(out / "shim.h"), "-o", str(lib),
         str(out / "harness.cpp")],
        capture_output=True, text=True)
    if proc.returncode and "c++20" in proc.stderr:
        pytest.skip(f"{cxx} has no C++20 (std::barrier): {proc.stderr[:200]}")
    assert proc.returncode == 0, proc.stderr
    h = ctypes.CDLL(str(lib))
    h.fp_words.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    for name, k in (("k12", 4), ("k13", 4), ("k14", 6)):
        getattr(h, name).argtypes = [ctypes.c_void_p] * k + [ctypes.c_longlong]
    return h


def _words(x: int):
    return [(x >> (32 * k)) & 0xFFFFFFFF for k in range(12)]


def _value(w) -> int:
    return sum(int(v) << (32 * k) for k, v in enumerate(w))


def test_fp_words_match_integers(host_lib):
    """fp_mul is the word-level CIOS integer (a b + m p) / 2^384 (m the
    unique quotient in [0, 2^384)), fp_add and fp_sub the lazy [0, 2p) sum
    and difference, on edge pairs and random pairs below 2p."""
    edges = [0, 1, P - 1, P, P + 1, 2 * P - 1, R % P, (1 << 381) - 1]
    rng = random.Random(8)
    pairs = [(x, y) for x in edges for y in edges]
    pairs += [(rng.randrange(2 * P), rng.randrange(2 * P)) for _ in range(1000)]
    a = np.array([_words(x) for x, _ in pairs], np.uint32)
    b = np.array([_words(y) for _, y in pairs], np.uint32)
    out = np.zeros((len(pairs), 36), np.uint32)
    harness_call(lambda: host_lib.fp_words(a.ctypes.data, b.ctypes.data,
                                           out.ctypes.data, len(pairs)), out)
    ninv = pow(P, -1, R)
    for (x, y), o in zip(pairs, out):
        assert _value(o[:12]) == (x * y + ((-x * y * ninv) % R) * P) // R
        assert _value(o[12:24]) == (x + y if x + y < 2 * P else x + y - 2 * P)
        assert _value(o[24:]) == (x - y if x >= y else x - y + 2 * P)


def _branches(u_limbs):
    """(tv2 == 0, gx1 square, sgn0 flip) of one u, in the oracle's Fq2 and
    the kernels' candidate order (RFC 9380 F.2.1 as htc.cuh sqrt_ratio)."""
    A, B, Z, cands = htc.sswu_derived_constants()
    e = htc.SQRT_RATIO_E
    u = Fq2(*tower.fp2_from_dev(u_limbs))
    tv1 = Z * u.square()
    tv2 = tv1.square() + tv1
    den = Z * A if tv2.is_zero() else -(A * tv2)
    num1 = B * (tv2 + Fq2.one())
    gxn = num1.square() * num1 + A * num1 * den.square() + B * den.square() * den
    gxd = den.square() * den
    t = gxn * gxd.pow(7) * (gxn * gxd.pow(15)).pow(e)
    for base, target, square in ((t, gxn, True), (t * Z.pow(1 + e), Z * gxn, False)):
        for c in cands:
            if (base * c).square() * gxd == target:
                y = base * c if square else tv1 * u * base * c
                return bool(tv2.is_zero()), square, u.sgn0() != y.sgn0()
    raise AssertionError("no sqrt_ratio candidate hit")


@pytest.fixture(scope="module")
def edge_us():
    """Four messages' u: b"" and b"abc", u = 0 on both halves (tv2 == 0),
    and b"abc"'s u0 on both halves (Q0 + Q1 takes the doubling). Between
    them both sqrt_ratio legs, with and without the sgn0 flip."""
    u = htc.hash_to_field_dev([b"", b"abc"])
    us = np.concatenate([u, np.zeros_like(u[:1]), np.repeat(u[1:2, :1], 2, axis=1)])
    cover = {_branches(us[i, h]) for i in range(3) for h in range(2)}
    assert {c[0] for c in cover} == {True, False}
    assert {(c[1], c[2]) for c in cover} >= {(True, False), (True, True),
                                             (False, False), (False, True)}
    return torch.from_numpy(us)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _out(n):
    return torch.zeros(3, n, 2, 48, dtype=torch.int32)


def test_map_to_g2_warp_body_matches_plain(host_lib, edge_us):
    """K12: one message per warp, the u-halves on the half-warps, then
    Q0 + Q1 and the cofactor on the warp; raw limbs of the plain map."""
    n = edge_us.shape[0]
    out = _out(n)
    harness_call(lambda: host_lib.k12(_ptr(edge_us), _ptr(out[0]), _ptr(out[1]),
                                      _ptr(out[2]), n), out)
    want = th.map_to_g2_resident_plain(edge_us)
    for got, w in zip(out, want):
        assert torch.equal(got, w)


def test_sswu_iso_and_cofactor_warp_bodies_match_plain(host_lib, edge_us):
    """K13 on an odd count of u (the last block's second half-warp has none)
    and K14 on a point and a point at infinity; raw limbs."""
    flat = torch.cat([edge_us[:, 0], edge_us[:, 1]])[:7].contiguous()
    out = _out(7)
    harness_call(lambda: host_lib.k13(_ptr(flat), _ptr(out[0]), _ptr(out[1]),
                                      _ptr(out[2]), 7), out)
    J = th.sswu_iso_plain(flat)
    for got, w in zip(out, J):
        assert torch.equal(got, w)
    Q = tuple(c[:2].clone() for c in J)
    Q[2][1] = 0
    out = _out(2)
    harness_call(lambda: host_lib.k14(*(_ptr(c) for c in Q), _ptr(out[0]),
                                      _ptr(out[1]), _ptr(out[2]), 2), out)
    for got, w in zip(out, th.cofactor_plain(Q)):
        assert torch.equal(got, w)


def test_hash_kernels_meet_only_within_a_warp():
    """K12-K14 are one warp per block and synchronise only with
    __syncwarp over a group (htc.cuh on warp_curve.cuh's groups and group
    law); no block-wide barrier and no coop.cuh program on their path. The
    wrapper's launch shape is the sources'."""
    text = "".join((CSRC / name).read_text()
                   for name in ("htc.cu", "htc.cuh", "warp_curve.cuh"))
    assert '#include "warp_curve.cuh"' in text
    assert "__syncthreads" not in text and "coop" not in text
    assert "__syncwarp" in text
    warp = int(re.search(r"kWarpThreads = (\d+);", (CSRC / "lanes.cuh").read_text()).group(1))
    half = int(re.search(r"kHalfThreads = (\d+);", (CSRC / "htc.cuh").read_text()).group(1))
    assert warp == th.THREADS_PER_MESSAGE == 2 * half == 32
    assert th.WARPS_PER_BLOCK == 1
    assert re.search(r"map_to_g2_kernel<<<\(unsigned int\)n, kWarpThreads", text)
