#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lighthouse_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run: S=128 sets x K=512 keys

In order, and failing (nonzero exit, no result line) at the first fault:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every registered kernel from the sources in this checkout, one
   nvcc per source, all started together; the seconds of each build and
   each kernel's registers, spills and stack from ``ptxas -v``; then the
   cycles of one Fp product (and sum) in one thread, from the probe
   ``csrc/fp_probe.cu`` (no path runs it);
3. K1 against its plain PyTorch version: bit equality on 2^20 random values
   in [0, 2p) plus the edge rows, on ragged sizes off its 64-product tile
   and on broadcast operands, big-int agreement on a sample; its time per
   call (CUDA events around one call, median of repetitions), its
   device-only time and its host enqueue per call;
4. each fused verify kernel (K2-K4, K8-K11) and the full-order subgroup
   check K15 against its plain version on the card, at the shapes the fused
   path gives it and with its edge lanes (infinity, Z = 1, scalars 0, 1,
   2^64-1 and single one bits, a base at infinity, points outside G2; for
   K2 also Z = 0, Z = p, Z in [p, 2p) and Z = p - 1): equality after
   ``canonical`` (and whether the raw limbs match; K2, K3, K8, K10 and
   K11, each of its three modes, must match raw), its time per call and
   device-only (K2 also its host enqueue), K4 also against K15, K9 also
   raw against its ``ops/coop.py`` plan's model (the divstep
   inversion's representative; against its plain
   version after canonical), the chain from K10 on raw against the plain
   chain on the plain K9's output, and the whole final-exponentiation chain
   against the plain chain and the classic ``pairing.final_exponentiation``
   after canonical; kernel and plain times; for K8-K11 the product and add
   rounds per lane of their ``ops/coop.py`` programs, their shared memory
   and the time per round; for K3, K4 and K15 (a lane on a group of a
   warp's threads on ``csrc/warp_curve.cuh``: the whole warp up to one
   lane per SM, packed past that; K4 and K15 one thread per lane past a
   few packed warps per SM) the launch shape, the rounds per lane, counted
   from the bits, and the time per round; then K3 G1 and G2 at 128, 256,
   512 and 2048 lanes in both shapes, raw-equal and device-only, K4 at
   128-8192 lanes in its three shapes, equal to its plain version and K15,
   and K15 (the NAF of r) in the same three shapes at 128, 396, 2048,
   6336 and 8192 lanes, equal to its plain version and K4, each
   device-only in three alternating turns beside the shape the launch
   takes;
5. the MSM kernels (K5 accumulate, K6 tree and K7 Horner on groups of
   threads of ``csrc/warp_curve.cuh``) against their plain
   versions at the main path's shapes (the batch's 128 signatures, a
   schedule from seeded scalars, L = 48), on all 256 lanes (K5 in the
   launch's shape raw against ``msm.accum_segments_plain``, its segment
   model, and against ``accum_plain`` at canonical affine, its rounds on
   the slowest group and time per round; K6 raw, its rounds on the slowest
   block and time per round; K7 on lane 0, raw limbs, its
   rounds and time per round), then on the edge batch (a duplicate
   signature whose mixed addition doubles, S and -S cancelling in a bucket
   before a further addition, an empty bucket), with every set skipped
   (K5 there at each of its segment counts), K7 on windows and K6 on
   buckets that take every leg of the complete addition; the MSM point
   against the scan (K3 G2 and the S-leaf tree) and the oracle's sum
   r_i S_i at canonical affine; kernel-only times of the MSM against the
   scan at S=2048, where K3 G2 and K6 also run raw-equal to their plain
   versions, and K6's device-only time there; K5 at
   S = 128, 512, 2048, 4096 and 8192 at each segment count (1-32 segments
   per bucket, each on a group of 8 threads), equal to ``accum_plain`` at
   canonical affine, device-only in five alternating turns, beside the
   segments the launch takes and the deepest bucket;
6. the hash kernels (K12 resident map, K13 SSWU + isogeny, K14 cofactor;
   one warp per message, htc.cu's ptxas lines repeated) against their
   plain versions, raw limbs equal, at the shapes the batch's 128 distinct
   messages give them and on edge lanes (u = 0 on both halves, u0 == u1,
   a lane at infinity, the RFC 9380 J.10.1 messages, an odd count of u),
   both SSWU branches among the lanes; their rounds per lane and the time
   per round; K12 + K2 against the RFC vectors; the device hash, resident
   and chained, against the oracle's points of all 128 messages;
7. the main path, the card's default, through the user entry point
   ``TorchBackend().verify_signature_sets`` at a mainnet block's size:
   S=128 aggregate attestations of K=512 keys, fused verify with the device
   hash (K12) and the MSM (K5-K7). The valid batch must verify True, the
   batch with two signatures swapped False;
8. the same two batches with the scan in place of the MSM (``msm=False``),
   the valid batch with the host oracle's hash (``device_htc=False``), and
   the classic configuration (``fused=False, device_htc=False``) on the
   valid and swapped batches;
9. two small batches through every configuration, the chained hash
   (``htc_resident=False``) among them, against the pure-Python oracle;
10. K1 at every size the main path launched it with (bit equality, time
    per call, device-only L2-warm and L2-cold, host enqueue) and its
    totals per verify; the
    device time of a default verify summed from the kernels' device-only
    times and launches; the ``kernels`` JSON line, the nvidia-smi line,
    and the result line.

A time per call spans one launch between two CUDA events on an idle card,
so it holds the host's enqueue; a device-only time is R launches back to
back between one pair of events, queued behind a spin kernel, over R,
L2-warm where the launches share their operands (K1 at 2^20 reads 604 MB,
beyond the 50 MB L2, all the same), L2-cold where each launch has its own
operands and a 256 MiB write evicted the L2 before them; a host enqueue
is the host clock over R calls with one sync after.

Kernel launch counts are zeroed just before each verify and read just after
it. Each configuration has its list: the default fused path must launch K1,
K2, K3 G1, K4, K5-K7 (once each), K8-K12 (K8 once, K10 five times) and not
K3 G2, K13, K14 or K15; with ``msm=False`` K3 G2 and not K5-K7; with the
chained hash K13 and K14 and not K12; with the host hash none of K12-K14;
the classic path K1 and none of the others. No verify launches K15: its
launches are those of the K4-against-K15 check.

Imports nothing of JAX or of the JAX package. Data comes from a seeded
numpy generator (secret keys sk_i = base + i, so pk_{i+1} = pk_i + G1).
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at its 700 W limit
# Hopper issues 64 32-bit integer multiply-adds per SM per clock; 132 SMs.
INT_MADS_PER_CLOCK = 132 * 64
# One Fp product: 12x12 word products for a*b and 12x12 for m*p, each a
# low and a high 32-bit multiply-add (576), plus the 12 quotient words at
# two each (24).
MADS_PER_FP_PRODUCT = 576 + 24

N_SETS, N_KEYS = 128, 512   # a mainnet block's aggregate attestations
N_VALUES = 1 << 20          # products in the K1-vs-plain check
REPS = 20                   # timed repetitions of K1
KERNEL_REPS = 5             # timed repetitions of a fused kernel
DEVICE_REPS = 10            # back-to-back launches of a device-only time
PLAIN_REPS = 3              # of a plain version (launch-bound, seconds)

# RFC 9380 J.10.1, suite BLS12381G2_XMD:SHA-256_SSWU_RO_: message -> affine
# ((x.c0, x.c1), (y.c0, y.c1)) under the RFC's own DST.
RFC_DST = b"QUUX-V01-CS02-with-BLS12381G2_XMD:SHA-256_SSWU_RO_"
RFC_J10_1 = {
    b"": (
        (0x0141EBFBDCA40EB85B87142E130AB689C673CF60F1A3E98D69335266F30D9B8D4AC44C1038E9DCDD5393FAF5C41FB78A,
         0x05CB8437535E20ECFFAEF7752BADDF98034139C38452458BAEEFAB379BA13DFF5BF5DD71B72418717047F5B0F37DA03D),
        (0x0503921D7F6A12805E72940B963C0CF3471C7B2A524950CA195D11062EE75EC076DAF2D4BC358C4B190C0C98064FDD92,
         0x12424AC32561493F3FE3C260708A12B7C620E7BE00099A974E259DDC7D1F6395C3C811CDD19F1E8DBF3E9ECFDCBAB8D6),
    ),
    b"abc": (
        (0x02C2D18E033B960562AAE3CAB37A27CE00D80CCD5BA4B7FE0E7A210245129DBEC7780CCC7954725F4168AFF2787776E6,
         0x139CDDBCCDC5E91B9623EFD38C49F81A6F83F175E80B06FC374DE9EB4B41DFE4CA3A230ED250FBE3A2ACF73A41177FD8),
        (0x1787327B68159716A37440985269CF584BCB1E621D3A7202BE6EA05C4CFE244AEB197642555A0645FB87BF7466B2BA48,
         0x00AA65DAE3C8D732D10ECD2C50F8A1BAF3001578F71C694E03866E9F3D49AC1E1CE70DD94A733534F106D4CEC0EDDD16),
    ),
    b"abcdef0123456789": (
        (0x121982811D2491FDE9BA7ED31EF9CA474F0E1501297F68C298E9F4C0028ADD35AEA8BB83D53C08CFC007C1E005723CD0,
         0x190D119345B94FBD15497BCBA94ECF7DB2CBFD1E1FE7DA034D26CBBA169FB3968288B3FAFB265F9EBD380512A71C3F2C),
        (0x05571A0F8D3C08D094576981F4A3B8EDA0A8E771FCDCC8ECCEAF1356A6ACF17574518ACB506E435B639353C2E14827C8,
         0x0BB5E7572275C567462D91807DE765611490205A941A5A6AF3B1691BFE596C31225D3AABDF15FAFF860CB4EF17C7C3BE),
    ),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median time of one call of fn() between a pair of CUDA events, over
    reps runs. The span holds the host's enqueue as well as the device's
    work (an idle card waits for the launch): the per-call time the table
    has always carried. ``device_ms`` and ``host_ms`` split it."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


SPIN_CYCLES_PER_S = 2.0e9   # torch.cuda._sleep cycles: above the SM clock


def device_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Device time per call of fn(): after a warm-up, reps calls back to
    back between one pair of CUDA events, divided by reps. The calls are
    queued behind a spin kernel that outlasts their enqueue, so the device
    runs them without waiting on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0  # host and device, at least the enqueue
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SPIN_CYCLES_PER_S * (reps * one + 1e-3)))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


L2_FLUSH_BYTES = 256 << 20  # five times the H100's 50 MB L2


def device_cold_ms(torch, fns, reps: int = 20, warmup: int = 2) -> float:
    """device_ms with each call's operands outside the L2: fns holds
    warmup + 1 + reps calls on distinct operands, taken in turn, and a
    256 MiB write evicts the L2 just before the first of them."""
    if len(fns) < warmup + 1 + reps:
        raise ValueError("device_cold_ms needs a call per launch")
    calls = iter(fns)
    torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda").zero_()
    return device_ms(torch, lambda: next(calls)(), reps, warmup)


def host_ms(torch, fn, reps: int = 20, warmup: int = 2) -> float:
    """Host enqueue per call of fn(): the host clock over reps calls with
    no sync between them; the one sync comes after the window."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t * 1e3 / reps


def random_fp(np, rng, n: int):
    """n random values in [0, 2p) as int32 [n, 48] byte limbs: uniform low
    bytes, top byte below 0x34 (2p's top byte is 0x34)."""
    limbs = rng.integers(0, 256, size=(n, 48), dtype=np.int32)
    limbs[:, 47] = rng.integers(0, 0x34, size=n, dtype=np.int32)
    return limbs


class GpuSampler:
    """nvidia-smi sampling (every 100 ms) around a window: the share of time
    a kernel was running (utilization.gpu), SM clock and power draw."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        )
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue  # a partial line cut by terminate
        self.summary = {
            "samples": len(rows),
            "gpu_util_pct": statistics.mean(r[0] for r in rows) if rows else None,
            "sm_clock_mhz": statistics.mean(r[1] for r in rows) if rows else None,
            "sm_clock_mhz_max": max(r[1] for r in rows) if rows else None,
            "power_w": statistics.mean(r[2] for r in rows) if rows else None,
        }
        return False


# ------------------------------------------------------------ phase 2: build


def build(torch):
    """Every registered kernel's library and the product probe's, all
    started together; returns the probe's library."""
    from lighthouse_tpu_torch.ops import _build

    probe = _build.CudaLibrary("fp_probe.cu")
    proc = probe.start_build()
    seconds = _build.build_all()
    probe.finish_build(proc)
    log(f"built {len(seconds)} libraries for {len(_build.KERNELS)} kernels, "
        f"nvcc seconds from the common start: {json.dumps(seconds)}")
    for lib in [*{id(k.library): k.library for k in _build.KERNELS}.values(), probe]:
        for line in ptxas_summary(lib.build_log):
            log(f"ptxas {lib.source.name}: {line}")
    return probe


def probe_product(torch, np, probe, iters: int = 4096) -> None:
    """Cycles (clock64) per fp_mul in one thread's loop of dependent calls
    (csrc/fp_probe.cu): one chain per thread, two independent chains per
    thread, and with 4 or 8 warps in the block (one or two per SM
    sub-partition); and per fp_add. Two chains at twice the cycles of one
    mean that the warp's instruction issue, not the chain's latency, sets a
    product's time."""
    import ctypes

    fn = probe.load().lh_fp_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    limbs = random_fp(np, np.random.default_rng(5), 2).astype(np.int64)
    words = limbs[:, 0::4] | limbs[:, 1::4] << 8 | limbs[:, 2::4] << 16 | limbs[:, 3::4] << 24
    inp = torch.from_numpy(words.reshape(-1).astype(np.uint32).view(np.int32)).cuda()
    out = torch.empty(256 * 12, dtype=torch.int32, device="cuda")
    cyc = torch.empty(1, dtype=torch.int64, device="cuda")
    res = {}
    for label, mode, threads in (("fp_mul, 1 warp", 0, 32),
                                 ("fp_mul x2 independent, 1 warp", 1, 32),
                                 ("fp_mul, 4 warps", 0, 128),
                                 ("fp_mul, 8 warps", 0, 256),
                                 ("fp_add, 1 warp", 2, 32)):
        for _ in range(2):  # the second run is kept
            rc = fn(inp.data_ptr(), out.data_ptr(), cyc.data_ptr(), mode, iters,
                    threads, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"fp_probe launch failed: CUDA error {rc}")
            torch.cuda.synchronize()
        res[label] = int(cyc.item()) / iters
    log(f"product probe, clock64 cycles per call in one thread's dependent "
        f"loop: {json.dumps(res)}")


def ptxas_summary(text: str) -> list[str]:
    """Registers, spills and stack of each kernel entry in ``ptxas -v``
    output (the out-of-line device functions are left out)."""
    stack, entries, cur = {}, [], None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entries.append([line.split("'")[1], None])
        elif "Function properties for" in line:
            cur = line.rsplit(" ", 1)[-1]
        elif "stack frame" in line and cur:
            stack[cur], cur = line.strip(), None
        elif "Used" in line and entries and entries[-1][1] is None:
            entries[-1][1] = line.split("Used", 1)[1].strip()
    return [f"{name}: used {used}; {stack.get(name, 'no stack line')}"
            for name, used in entries]


# ----------------------------------------------------------- phase 3: K1


def check_mont_mul(torch, np, n_values: int, reps: int) -> dict:
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import field, mont_mul

    R = 1 << 384
    edges = [0, 1, P - 1, P, 2 * P - 1, R % P]
    rng = np.random.default_rng(20261016)
    a = random_fp(np, rng, n_values)
    b = random_fp(np, rng, n_values)
    a[-36:] = field.ints_to_limbs([x for x in edges for _ in edges])
    b[-36:] = field.ints_to_limbs([y for _ in edges for y in edges])
    ta = torch.from_numpy(a).cuda()
    tb = torch.from_numpy(b).cuda()

    chunk = 1 << 16  # the plain version's [n, 48, 48] products, in slices

    def plain():
        return torch.cat([
            mont_mul.mont_mul_plain(ta[i:i + chunk], tb[i:i + chunk])
            for i in range(0, n_values, chunk)
        ])

    got = mont_mul.mont_mul_cuda(ta, tb)
    want = plain()
    torch.cuda.synchronize()
    match = bool(torch.equal(got, want))
    max_abs_err = int((got.to(torch.int64) - want).abs().max().item())
    if not match:
        raise AssertionError(f"mont_mul kernel != plain (max |err| {max_abs_err})")

    # big-int agreement on a sample (random rows + every edge row)
    rows = list(rng.choice(n_values - 36, size=512, replace=False)) + list(
        range(n_values - 36, n_values))
    g = got[torch.as_tensor(rows, device=got.device)].cpu().numpy()
    ninv = pow(P, -1, R)
    for r, out in zip(rows, g):
        x = field.limbs_to_int(a[r])
        y = field.limbs_to_int(b[r])
        t = x * y
        if field.limbs_to_int(out) != (t + ((-t * ninv) % R) * P) // R:
            raise AssertionError(f"mont_mul row {r} disagrees with big ints")

    # ragged sizes (not a multiple of the 64-product tile, and one tile
    # short of and past a whole number of the persistent grid's walks) and
    # broadcast operands, raw limbs
    ragged = [1, 54, 63, 65, 12345, n_values - 37]
    for m in ragged:
        if not torch.equal(mont_mul.mont_mul_cuda(ta[:m], tb[-m:]),
                           mont_mul.mont_mul_plain(ta[:m], tb[-m:])):
            raise AssertionError(f"mont_mul kernel != plain at n={m}")
    k = tb[n_values - 1]
    two = torch.stack([ta[:5000], tb[:5000]])
    for x, y in ((ta[:5000], k), (k[None], tb[:333]), (two, tb[7000:12000]),
                 (two[:, :1], tb[:77])):
        if not torch.equal(mont_mul.mont_mul_cuda(x, y), mont_mul.mont_mul_plain(x, y)):
            raise AssertionError(f"mont_mul kernel != plain broadcasting "
                                 f"{list(x.shape)} by {list(y.shape)}")
    torch.cuda.synchronize()

    def run():
        return mont_mul.mont_mul_cuda(ta, tb)

    kernel_ms = median_ms(torch, run, reps)
    dev_ms = device_ms(torch, run, reps)
    enqueue_ms = host_ms(torch, run, reps)
    plain_ms = median_ms(torch, plain, max(3, reps // 4), warmup=1)
    log(f"mont_mul: {n_values} products, bit-equal to plain: {match}, "
        f"big-int sample of {len(rows)} rows ok; bit-equal at n in {ragged} "
        f"and broadcasting; per call {kernel_ms:.4f} ms, device-only "
        f"{dev_ms:.4f} ms ({576 * n_values / HBM_BYTES_PER_S * 1e3 / dev_ms:.1%} "
        f"of the bytes bound), host enqueue {enqueue_ms * 1e3:.2f} us; "
        f"plain {plain_ms:.4f} ms")
    return {
        "name": mont_mul.K1.name,
        "route": mont_mul.K1.route,
        "source": mont_mul.K1.source,
        "replaces": mont_mul.K1.replaces,
        "launches": None,   # filled from the main path's run
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "device_ms": dev_ms,
        "host_ms": enqueue_ms,
        "plain_ms": plain_ms,
        "bytes": 576 * n_values,
        "fp_products": n_values,
        "library_ms": None,  # no single PyTorch call computes a Montgomery product
        "n": n_values,
        "match": match,
        "match_raw": match,
    }


def time_at_path_shape(torch, np, entry: dict, sizes, reps: int) -> None:
    """K1 vs plain at every product count the fused path launched K1 with
    (bit equality and times at each), and its total per verify: the sum
    over sizes of a time times the launches there, for the per-call time
    (CUDA events around one call), the device-only time, L2-warm (the same
    operands every launch, as the path's operands come just written by
    the glue) and L2-cold (each launch on operands evicted from the L2),
    and the host enqueue, beside the same sum of bounds (bytes: 576 B per
    product, from device memory)."""
    from lighthouse_tpu_torch.ops import mont_mul

    total = {"ms": 0.0, "device_ms": 0.0, "device_cold_ms": 0.0, "host_ms": 0.0}
    bound = 0.0
    for n, count in sorted(sizes.items()):
        rng = np.random.default_rng(n)
        ta = torch.from_numpy(random_fp(np, rng, n)).cuda()
        tb = torch.from_numpy(random_fp(np, rng, n)).cuda()
        if not torch.equal(mont_mul.mont_mul_cuda(ta, tb),
                           mont_mul.mont_mul_plain(ta, tb)):
            raise AssertionError(f"mont_mul kernel != plain at n={n}")

        def run():
            return mont_mul.mont_mul_cuda(ta, tb)

        # a distinct operand pair for every launch of the L2-cold time
        sets = [torch.randint(0, 256, (reps + 3, n, 48), dtype=torch.int32,
                              device="cuda") for _ in range(2)]
        for limbs in sets:
            limbs[..., 47] %= 0x34
        cold = [lambda i=i: mont_mul.mont_mul_cuda(sets[0][i], sets[1][i])
                for i in range(reps + 3)]
        t = {"ms": median_ms(torch, run, reps), "device_ms": device_ms(torch, run, reps),
             "device_cold_ms": device_cold_ms(torch, cold, reps),
             "host_ms": host_ms(torch, run, reps)}
        del sets, cold
        bound += count * 576 * n / HBM_BYTES_PER_S * 1e3
        for key, v in t.items():
            total[key] += count * v
        if (n, count) == sizes.most_common(1)[0]:
            entry["path_n"], entry["path_n_launches"] = n, count
            for key, v in t.items():
                entry[f"path_{key}"] = v
            entry["path_plain_ms"] = median_ms(
                torch, lambda: mont_mul.mont_mul_plain(ta, tb), reps)
            path_bound = 576 * n / HBM_BYTES_PER_S * 1e3
    for key, v in total.items():
        entry[f"path_total_{key}"] = v
    log(f"mont_mul at the fused path's most common size n={entry['path_n']} "
        f"({entry['path_n_launches']} launches): per call {entry['path_ms']:.4f} ms, "
        f"device-only {entry['path_device_ms']:.4f} ms L2-warm, "
        f"{entry['path_device_cold_ms']:.4f} ms L2-cold (bytes bound "
        f"{path_bound:.5f} ms), host enqueue {entry['path_host_ms'] * 1e3:.2f} us, "
        f"plain {entry['path_plain_ms']:.4f} ms; over all {sum(sizes.values())} "
        f"launches at {len(sizes)} sizes, bit-equal at each, per verify: per-call "
        f"sum {total['ms']:.4f} ms, device-only {total['device_ms']:.4f} ms "
        f"L2-warm, {total['device_cold_ms']:.4f} ms L2-cold, host enqueue "
        f"{total['host_ms']:.4f} ms (bound {bound:.4f} ms); sizes (products: "
        f"launches) {dict(sorted(sizes.items()))}")


# ------------------------------------------------------ the batch of sets


def build_batch(np, n_sets: int, n_keys: int, seed: int):
    """S sets of K keys: sk_i = base + i, pk_{i+1} = pk_i + G1; set s
    signs message m_s with the sum of its keys' secrets. Returns the sets
    and the hashes H(m_s)."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.crypto.bls.constants import R
    from lighthouse_tpu_torch.crypto.bls.curve import g1_generator
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2

    rng = np.random.default_rng(seed)
    base = int.from_bytes(rng.bytes(32), "little") % (R - n_sets * n_keys - 1) + 1
    g = g1_generator()
    pk = g.mul(base)
    pks = []
    for _ in range(n_sets * n_keys):
        pks.append(api.PublicKey(pk))
        pk = pk.add(g)
    sets, hashes = [], []
    for s in range(n_sets):
        msg = hashlib.sha256(rng.bytes(32) + s.to_bytes(4, "little")).digest()
        lo = s * n_keys
        sk_sum = (n_keys * base + n_keys * lo + n_keys * (n_keys - 1) // 2) % R
        h = hash_to_g2(msg)
        hashes.append(h)
        sets.append(api.SignatureSet(api.AggregateSignature(h.mul(sk_sum)),
                                     pks[lo:lo + n_keys], msg))
    return sets, hashes


# ------------------------------------------------ phase 4: fused kernels


def fp_product_counts(P: int) -> dict:
    """Fp products per lane of each piece of the kernels' schedules,
    counted from csrc/tower.cuh, curve.cuh and the kernel sources."""
    c = {"fp2_mul": 3, "fp2_sqr": 2}
    c["fp6_mul"] = 6 * c["fp2_mul"]
    c["fp12_mul"] = 3 * c["fp6_mul"]
    c["fp12_sqr"] = 2 * c["fp6_mul"]
    c["inv"] = (P - 2).bit_length() - 1 + bin(P - 2)[3:].count("1")
    c["fp2_inv"] = 2 + c["inv"] + 2
    c["fp12_inv"] = 4 * c["fp6_mul"] + 12 * c["fp2_mul"] + c["fp2_inv"]
    c["fp12_frob"] = 2 * 2 * c["fp2_mul"] + 3 * c["fp2_mul"]
    # group law: pt_double 5 squares + 2 products; pt_add_mixed 5 + 7
    c["dbl_g1"], c["madd_g1"] = 7, 12
    c["dbl_g2"] = 5 * c["fp2_sqr"] + 2 * c["fp2_mul"]
    c["madd_g2"] = 5 * c["fp2_sqr"] + 7 * c["fp2_mul"]
    # Miller: doubling step 6 squares + 5 products, addition step 5 + 9,
    # sparse line product 2 mul_fp (2 each) + 13 Fp2 products
    c["dbl_step"] = 6 * c["fp2_sqr"] + 5 * c["fp2_mul"]
    c["add_step"] = 5 * c["fp2_sqr"] + 9 * c["fp2_mul"]
    c["sparse"] = 4 + 13 * c["fp2_mul"]
    # hash kernels (csrc/htc.cuh): the complete addition 5 squares + 11
    # products; the sqrt_ratio power over E = (p^2-9)/16; its fixed prefix
    # (2 squares, 6 products); a candidate check (a product, a square, a
    # product); the Z candidates' set-up (2 products); the SSWU glue before
    # sqrt_ratio (4 squares, 9 products); the non-square legs (3 products);
    # sgn0 (2 Fp products each, twice); the isogeny (power tables, 15
    # polynomial terms of 2 products, the Jacobian packing)
    e = (P * P - 9) // 16
    c["add_g2"] = 5 * c["fp2_sqr"] + 11 * c["fp2_mul"]
    c["pow_e"] = (e.bit_length() - 1) * c["fp2_sqr"] + (bin(e).count("1") - 1) * c["fp2_mul"]
    c["sqrt_fixed"] = 2 * c["fp2_sqr"] + 6 * c["fp2_mul"]
    c["cand_check"] = 2 * c["fp2_mul"] + c["fp2_sqr"]
    c["z_setup"] = 2 * c["fp2_mul"]
    c["sswu_fixed"] = 4 * c["fp2_sqr"] + 9 * c["fp2_mul"]
    c["non_square"] = 3 * c["fp2_mul"]
    c["sgn0"] = 2 * 2
    c["iso"] = 2 * (c["fp2_sqr"] + c["fp2_mul"]) + 15 * 2 * c["fp2_mul"] \
        + 3 * c["fp2_sqr"] + 8 * c["fp2_mul"]
    c["cofactor"] = 127 * c["dbl_g2"] + 15 * c["add_g2"] + 3 * 2 * c["fp2_mul"]
    return c


def gcd_inverse_ops() -> int:
    """32-bit integer operations of one fp.cuh gcd_inverse (K2's
    inversion), with the loop counts read from the source (kDivstepBatch,
    kDivstepBatches, the limbs kS30) and the operations per step counted
    from it as written, a 64-bit add or shift and a 32x32 -> 64-bit
    multiply as 2 each: per divstep 29 (the masks, the three conditional
    negations and additions, the swap, delta, the three shifts); per limb
    of a batch update, update_fg_30 22 (4 products, 4 adds, 2 shifts, 2
    masks) and update_de_30 30 (6 products, 6 adds, 2 shifts, 2 masks),
    and 10 for update_de_30's multiples of p; ~300 for the reduction, the
    limb conversions and normalize_30."""
    import re

    text = (Path(__file__).resolve().parent
            / "lighthouse_tpu_torch/csrc/fp.cuh").read_text()
    batch, batches, limbs = (int(re.search(rf"{name} = (\d+);", text).group(1))
                             for name in ("kDivstepBatch", "kDivstepBatches", "kS30"))
    return batches * (batch * 29 + limbs * (22 + 30) + 10) + 300


def order_naf() -> list[int]:
    """The non-adjacent form of the curve order r, least significant digit
    first: the chain K15 runs (csrc/subgroup_fast.cu kOrderNaf*)."""
    from lighthouse_tpu_torch.crypto.bls.constants import R

    digits, k = [], R
    while k:
        d = 2 - k % 4 if k % 2 else 0
        digits.append(d)
        k = (k - d) // 2
    return digits


def subgroup_full_chain() -> tuple[int, int]:
    """(doublings, mixed additions) of K15 on one finite lane: a doubling
    per digit of the NAF of r below its top, a mixed addition of Q or -Q on
    each nonzero digit below it (255 and 59; the reference's binary chain
    254 doublings and 133 complete additions)."""
    digits = order_naf()
    return len(digits) - 1, sum(1 for d in digits[:-1] if d)


def subgroup_full_products(c: dict) -> int:
    """K15's Fp products for one finite lane, on the chain it runs: the
    least known work for its verdict."""
    dbl, madd = subgroup_full_chain()
    return dbl * c["dbl_g2"] + madd * c["madd_g2"]


def msm_products(np, c: dict, valid) -> dict:
    """Fp products of K5, K6 and K7 for this schedule: K5 a mixed addition
    for each point after a bucket's first (the first lands on infinity and
    costs none); K6 a complete addition wherever both lanes of a shift-add
    step are finite (the infinity pattern follows the buckets' counts); K7
    60 doublings and an addition per window whose sum is finite. Counted
    for points in general position, as random signatures and scalars give."""
    counts = np.zeros(256, np.int64)
    counts[:240] = valid.sum(axis=0)
    k5 = int(np.maximum(counts - 1, 0).sum()) * c["madd_g2"]
    inf = counts == 0
    k6 = 0
    for _ in range(2):
        for sh in (16, 32, 64, 128):
            q_inf = np.concatenate([inf[sh:], np.ones(sh, bool)])
            k6 += int((~inf & ~q_inf).sum()) * c["add_g2"]
            inf = inf & q_inf
    k7 = 60 * c["dbl_g2"] + int((~inf[:15]).sum()) * c["add_g2"]
    return {"msm_accum": k5, "msm_tree": k6, "msm_horner": k7}


def sswu_lane_work(u, consts) -> tuple[bool, int]:
    """(gx1 is a square, candidate checks made) for one u, by the kernels'
    own sqrt_ratio in the oracle's Fq2 arithmetic: the hits depend on the
    data, so the bound counts what these lanes need."""
    A, B, Z, cands, c_z, e = consts
    tv1 = Z * u.square()
    tv2 = tv1.square() + tv1
    num1 = B * (tv2 + type(u).one())
    den = Z * A if tv2.is_zero() else -(A * tv2)
    gxn = num1.square() * num1 + A * num1 * den.square() + B * den.square() * den
    gxd = den.square() * den
    t = gxn * gxd.pow(7) * (gxn * gxd.pow(15)).pow(e)
    for i, cand in enumerate(cands):
        if (t * cand).square() * gxd == gxn:
            return True, i + 1
    for i, cand in enumerate(cands):
        if (t * c_z * cand).square() * gxd == Z * gxn:
            return False, 5 + i
    return False, 8


def sswu_products(c: dict, work) -> int:
    """Fp products of the SSWU + isogeny body for one u."""
    is_sq, checks = work
    return (c["sswu_fixed"] + c["sqrt_fixed"] + c["pow_e"] + checks * c["cand_check"]
            + (0 if is_sq else c["z_setup"] + c["non_square"]) + c["sgn0"] + c["iso"])


# Rounds of the warp group law (csrc/warp_curve.cuh): a doubling 4, a
# complete or a mixed addition 6 (an addition onto infinity or of infinity
# returns at once: none), psi 1.
DBL_ROUNDS = 4
ADD_ROUNDS = 6
# Rounds of the hash bodies (csrc/htc.cuh): per u-half, SSWU's 7 rounds,
# sqrt_ratio's 6 before the power, the power's 757 squarings and 365
# products, t, the isogeny's 13 and sgn0(y)'s 1; 3 per candidate check, 1
# to set up the Z candidates, 2 for the non-square leg. The cofactor: two
# walks of 63 doublings and 5 additions, 5 more additions, a doubling, 3
# psi. Q0 + Q1: an addition.
SSWU_FIXED_ROUNDS = 7 + 6 + 757 + 365 + 1 + 13 + 1
COFACTOR_ROUNDS = (2 * (63 * DBL_ROUNDS + 5 * ADD_ROUNDS) + 5 * ADD_ROUNDS
                   + DBL_ROUNDS + 3)


def sswu_rounds(work) -> int:
    """Rounds of one u-half's SSWU + isogeny body."""
    is_sq, checks = work
    return SSWU_FIXED_ROUNDS + 3 * checks + (checks > 4) + 2 * (not is_sq)


def map_rounds(row) -> int:
    """Rounds of one K12 message: the halves' shared rounds once, each
    half's data-dependent rounds (candidates, non-square leg) in turn, as a
    warp runs legs its halves disagree on; then Q0 + Q1 and the cofactor."""
    return (SSWU_FIXED_ROUNDS + sum(sswu_rounds(w) - SSWU_FIXED_ROUNDS for w in row)
            + ADD_ROUNDS + COFACTOR_ROUNDS)


def scalar_mul_adds(np, inf, bits):
    """K3's mixed additions per lane: one on each one bit after the first
    (the first adds to infinity, which returns at once); lanes at infinity
    add nothing."""
    ones = bits.sum(axis=1)
    return np.where(inf | (ones == 0), 0, ones - 1)


def scalar_mul_rounds(np, inf, bits, lanes: int = 1) -> int:
    """Rounds of K3's slowest warp at ``lanes`` lanes per warp: a doubling
    per bit, and a mixed addition on each bit where a lane of the warp adds
    (a one bit after its first, on a base not at infinity), as the warp
    runs the addition once for all its groups that take it."""
    adds = (bits == 1) & (np.cumsum(bits, axis=1) > 1) & ~inf[:, None]
    n = bits.shape[0]
    adds = np.pad(adds, ((0, -n % lanes), (0, 0))).reshape(-1, lanes, bits.shape[1])
    return int(bits.shape[1] * DBL_ROUNDS + adds.any(axis=1).sum(axis=1).max() * ADD_ROUNDS)


def tree_rounds(np, valid) -> int:
    """Rounds of K6's slowest block (csrc/msm.cu: a block per window, its
    16 lanes meeting at __syncthreads after each shift-add step): per step,
    a complete addition's 6 where a lane of the window adds two finite
    points, none where every lane returns at once; with the infinity
    pattern msm_products counts (points in general position)."""
    counts = np.zeros(256, np.int64)
    counts[:240] = valid.sum(axis=0)
    inf = (counts == 0).reshape(16, 16)  # [row j, window w]: lane j * 16 + w
    rounds = np.zeros(16, np.int64)
    for _ in range(2):
        for s in (1, 2, 4, 8):
            q_inf = np.concatenate([inf[s:], np.ones((s, 16), bool)])
            rounds += (~inf & ~q_inf).any(axis=0) * ADD_ROUNDS
            inf = inf & q_inf
    return int(rounds.max())


def horner_rounds(c: dict, k7_products: int) -> int:
    """Rounds of K7: 60 doublings, and a complete addition for each of the
    additions msm_products counts in its Fp products."""
    return 60 * DBL_ROUNDS + (k7_products - 60 * c["dbl_g2"]) // c["add_g2"] * ADD_ROUNDS


def warp_report(torch, entry: dict, label: str, rounds: int, products: int,
                run, shape: str = "one warp per lane, one lane per block of one warp") -> None:
    """Measure a warp group law kernel's host enqueue per call into its
    kernels-line entry, and log its launch shape, its rounds on the slowest
    lane and its time per round (per call and device-only). The entry keeps
    only measured numbers, so the rounds stay in the log line."""
    entry["host_ms"] = host_ms(torch, run)
    log(f"{label}: {shape}; "
        f"{rounds} rounds on the slowest lane ({products} Fp products, which "
        f"one thread ran in a row); per call {entry['ms']:.4f} ms = "
        f"{entry['ms'] * 1e3 / rounds:.4f} us per round, device-only "
        f"{entry['device_ms']:.4f} ms = {entry['device_ms'] * 1e3 / rounds:.4f} us "
        f"per round; host enqueue {entry['host_ms'] * 1e3:.2f} us per call")


def k3_lanes_per_warp(tc, g2: bool, n: int) -> int:
    """The lanes per warp that K3's launch takes for n lanes on this card."""
    import ctypes

    lanes = ctypes.c_int(0)
    rc = tc.K3_G1.library.load().lh_scalar_mul_lanes_per_warp(
        ctypes.c_int(int(g2)), ctypes.c_longlong(n), ctypes.byref(lanes))
    if rc:
        raise RuntimeError(f"lh_scalar_mul_lanes_per_warp: CUDA error {rc}")
    return lanes.value


def warp_shape(lanes: int) -> str:
    """K3's or K4's launch shape at ``lanes`` lanes per warp."""
    if lanes == 1:
        return "one warp per lane, one lane per block of one warp"
    if lanes == 32:
        return "one thread per lane, 32 lanes per block of one warp"
    return f"{lanes} lanes per block of one warp, {32 // lanes} threads per lane"


def k3_shaped(torch, tc, g2: bool, lanes: int, x, y, inf, bits):
    """K3 at a given lanes per warp, through the library's
    lh_scalar_mul_shaped (not counted: the smoke's comparison of shapes)."""
    import ctypes

    from lighthouse_tpu_torch.ops import _build

    out = torch.empty((3, *x.shape), dtype=torch.int32, device=x.device)
    rc = tc.K3_G1.library.load().lh_scalar_mul_shaped(
        ctypes.c_int(int(g2)), ctypes.c_int(lanes),
        *(ctypes.c_void_p(t.data_ptr()) for t in (x, y, inf, bits, *out)),
        ctypes.c_int(bits.shape[1]), ctypes.c_longlong(x.shape[0]),
        ctypes.c_void_p(_build.current_stream(x)))
    if rc:
        raise RuntimeError(f"lh_scalar_mul_shaped({int(g2)}, {lanes}): CUDA error {rc}")
    return out[0], out[1], out[2]


def k3_lane_sweep(torch, np, sets, sizes=(128, 256, 512, 2048)) -> dict:
    """K3 G1 and G2 at n lanes (the bases of the batch's keys and
    signatures, repeated; seeded 64-bit scalars, as a verify of n sets
    draws) in both launch shapes, one warp per lane and packed: each raw-
    equal to pt_scalar_mul_bits, both device-only, with the shape the
    launch takes for n and each shape's rounds on its slowest warp.
    Returns {"g1 128": {...}, ...}."""
    from lighthouse_tpu_torch.ops import points
    from lighthouse_tpu_torch.ops import tkernel_calls as tc

    dev = torch.device("cuda")
    res = {}
    for g, F, packed in (("g1", points.FP_OPS, 8), ("g2", points.FP2_OPS, 4)):
        if g == "g1":
            bx, by, _ = points.g1_to_dev([s.signing_keys[0].point for s in sets])
        else:
            bx, by, _ = points.g2_to_dev([s.signature.point for s in sets])
        for n in sizes:
            rows = np.arange(n) % len(sets)
            bits_np = points.scalars_to_bits([int(k) for k in seeded_scalars(np, n, n)], 64)
            inf_np = np.zeros(n, bool)
            x, y, inf, bits = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                               for a in (bx[rows], by[rows], inf_np, bits_np))
            want = points.pt_scalar_mul_bits(F, (x, y), inf, bits)
            auto = k3_lanes_per_warp(tc, g == "g2", n)
            row = {"lanes_per_warp": auto}
            for shape, lanes in (("one_warp", 1), ("packed", packed)):
                def run(lanes=lanes):
                    return k3_shaped(torch, tc, g == "g2", lanes, x, y, inf, bits)
                if not all(torch.equal(a, b) for a, b in zip(run(), want)):
                    raise AssertionError(f"K3 {g} at {n} lanes, {lanes} per warp, "
                                         "!= pt_scalar_mul_bits in its raw limbs")
                rounds = scalar_mul_rounds(np, inf_np, bits_np, lanes)
                ms = device_ms(torch, run, DEVICE_REPS, warmup=1)
                row[shape] = {"lanes_per_warp": lanes, "device_ms": ms, "rounds": rounds,
                              "us_per_round": ms * 1e3 / rounds}
            fn = tc.scalar_mul_g1 if g == "g1" else tc.scalar_mul_g2
            if not all(torch.equal(a, b) for a, b in zip(fn(x, y, inf, bits), want)):
                raise AssertionError(f"K3 {g} wrapper at {n} lanes != pt_scalar_mul_bits")
            res[f"{g} {n}"] = row
            log(f"K3 {g} at {n} lanes (seeded 64-bit scalars), raw-equal to its "
                f"plain version in both shapes; the launch takes {auto} per warp; "
                f"device-only: {json.dumps(row)}")
    return res


# Rounds of K4 on a finite lane: 63 doublings, 5 mixed additions, and
# psi with the comparison in 3 (csrc/subgroup_fast.cu); of K15, the NAF
# chain's doublings and mixed additions.
K4_ROUNDS = 63 * DBL_ROUNDS + 5 * ADD_ROUNDS + 3
K15_ROUNDS = (subgroup_full_chain()[0] * DBL_ROUNDS
              + subgroup_full_chain()[1] * ADD_ROUNDS)
# K4's lanes per warp: one warp per lane, packed, one thread per lane.
K4_SHAPES = {"one_warp": 1, "packed": 4, "one_thread": 32}


def subgroup_fast_products(c: dict) -> int:
    """K4's Fp products for one finite lane: 63 doublings, 5 mixed
    additions, psi's 2 Fp2 products, Z^2, Z^3 and the two comparisons'."""
    return (63 * c["dbl_g2"] + 5 * c["madd_g2"] + 2 * c["fp2_mul"] + c["fp2_sqr"]
            + 3 * c["fp2_mul"])


def k4_lanes(np, sets):
    """K4's 128 lanes: 96 signatures in G2, 28 points on the curve outside
    G2 (map_to_curve_g2 without cofactor clearing), 4 at infinity (a
    signature's limbs under the flag). Returns (x, y, inf) numpy arrays."""
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import map_to_curve_g2
    from lighthouse_tpu_torch.ops import points

    pts = [s.signature.point for s in sets[:96]]
    pts += [map_to_curve_g2(Fq2(s + 2, 3 * s + 1)) for s in range(28)]
    pts += [s.signature.point for s in sets[124:128]]
    x, y, inf = points.g2_to_dev(pts)
    inf[124:] = True
    return x, y, inf


def subgroup_lanes_per_warp(tc, n: int) -> int:
    """The lanes per warp that K4's and K15's launch takes for n lanes on
    this card."""
    import ctypes

    lanes = ctypes.c_int(0)
    rc = tc.K4.library.load().lh_subgroup_fast_lanes_per_warp(
        ctypes.c_longlong(n), ctypes.byref(lanes))
    if rc:
        raise RuntimeError(f"lh_subgroup_fast_lanes_per_warp: CUDA error {rc}")
    return lanes.value


def subgroup_shaped(torch, tc, check: str, lanes: int, x, y, inf):
    """K4 (check "fast") or K15 ("full") at a given lanes per warp, through
    the library's shaped entry (not counted: the smoke's comparison of
    shapes)."""
    import ctypes

    from lighthouse_tpu_torch.ops import _build

    entry = f"lh_subgroup_{check}_shaped"
    out = torch.empty(x.shape[0], dtype=torch.bool, device=x.device)
    rc = getattr(tc.K4.library.load(), entry)(
        *(ctypes.c_void_p(t.data_ptr()) for t in (x, y, inf, out)),
        ctypes.c_int(lanes), ctypes.c_longlong(x.shape[0]),
        ctypes.c_void_p(_build.current_stream(x)))
    if rc:
        raise RuntimeError(f"{entry}({lanes}): CUDA error {rc}")
    return out


# The lane counts of the subgroup checks' sweeps on 132 SMs: K4's about its
# crossovers (3 lanes per SM, 12 packed warps per SM), K15's about its own
# (3 lanes per SM; 8, 10, 11 and 12 packed warps per SM).
K4_SWEEP = (128, 256, 384, 512, 1024, 2048, 4096, 6144, 8192)
K15_SWEEP = (128, 396, 2048, 6336, 8192)


def subgroup_lane_sweep(torch, np, sets, check: str, sizes, turns: int = 3) -> dict:
    """K4 (check "fast") or K15 ("full") at n lanes (k4_lanes repeated:
    3/4 in G2, the rest outside G2 or at infinity, as a verify of n sets
    with some bad signatures gives it) in each launch shape: verdicts equal
    to its plain version's (K15's: pt_subgroup_check, the binary chain) and
    to the other check's; device-only in ``turns`` turns, the shapes in
    alternating order, the median kept beside the spread; the shape the
    launch takes for n, the rounds of a finite lane and the time per round
    (for one thread per lane: its Fp products in a row and the time per
    product). Returns {n: {...}}."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import points
    from lighthouse_tpu_torch.ops import tkernel_calls as tc

    F = points.FP2_OPS
    c = fp_product_counts(P)
    if check == "full":
        label, other, kernel, peer = "K15", "K4", tc.subgroup_check_g2, tc.subgroup_check_g2_fast
        chain, rounds = subgroup_full_products(c), K15_ROUNDS

        def plain(x, y, inf):
            return points.pt_subgroup_check(F, points.pt_from_affine(F, x, y, inf))
    else:
        label, other, kernel, peer = "K4", "K15", tc.subgroup_check_g2_fast, tc.subgroup_check_g2
        chain, rounds = subgroup_fast_products(c), K4_ROUNDS
        plain = points.subgroup_check_g2_fast
    base = [torch.from_numpy(np.ascontiguousarray(a)).cuda() for a in k4_lanes(np, sets)]
    res = {}
    for n in sizes:
        rows = torch.arange(n, device="cuda") % base[0].shape[0]
        x, y, inf = (t[rows].contiguous() for t in base)
        want = plain(x, y, inf)
        if not torch.equal(peer(x, y, inf), want):
            raise AssertionError(f"{other} disagrees with {label}'s plain version at {n} lanes")
        if not torch.equal(kernel(x, y, inf), want):
            raise AssertionError(f"{label} wrapper at {n} lanes != its plain version")
        runs = {}
        for shape, lanes in K4_SHAPES.items():
            def run(lanes=lanes):
                return subgroup_shaped(torch, tc, check, lanes, x, y, inf)
            if not torch.equal(run(), want):
                raise AssertionError(f"{label} at {n} lanes, {lanes} per warp, != its "
                                     f"plain version and {other}")
            runs[shape] = run
        times = {shape: [] for shape in K4_SHAPES}
        for turn in range(turns):
            order = list(K4_SHAPES) if turn % 2 == 0 else list(K4_SHAPES)[::-1]
            for shape in order:
                times[shape].append(device_ms(torch, runs[shape], DEVICE_REPS, warmup=1))
        auto = subgroup_lanes_per_warp(tc, n)
        row = {"lanes_per_warp": auto}
        for shape, lanes in K4_SHAPES.items():
            ms = statistics.median(times[shape])
            steps = chain if lanes == 32 else rounds
            row[shape] = {"lanes_per_warp": lanes, "device_ms": ms,
                          "device_ms_turns": times[shape],
                          "products_in_a_row" if lanes == 32 else "rounds": steps,
                          "us_per_product" if lanes == 32 else "us_per_round":
                              ms * 1e3 / steps}
        fastest = min(K4_SHAPES, key=lambda k: row[k]["device_ms"])
        row["fastest"] = K4_SHAPES[fastest]
        res[n] = row
        log(f"{label} at {n} lanes, each shape equal to its plain version and {other}; "
            f"the launch takes {auto} per warp, the fastest median measured "
            f"{K4_SHAPES[fastest]}; device-only: {json.dumps(row)}")
    return res


def scalar_mul_products(np, c: dict, g: str, inf, bits) -> int:
    """K3's Fp products for these lanes: 64 doublings each, and a mixed
    addition on each one bit after the first (the first adds to infinity,
    which returns at once); lanes at infinity add nothing."""
    adds = scalar_mul_adds(np, inf, bits).sum()
    return int(bits.shape[0] * bits.shape[1] * c[f"dbl_{g}"] + adds * c[f"madd_{g}"])


def compare(torch, got, want):
    """(raw limbs equal, equal after canonical, max |limb difference|)."""
    from lighthouse_tpu_torch.ops import field

    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    raw = canon = True
    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape} {g.dtype} vs {w.shape} {w.dtype}")
        raw &= bool(torch.equal(g, w))
        if g.dtype == torch.int32:
            canon &= bool(torch.equal(field.canonical(g), field.canonical(w)))
        else:
            canon &= bool(torch.equal(g, w))
        if g.numel():
            err = max(err, int((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
    return raw, canon, err


def check_kernel(torch, kernel, label, run_kernel, run_plain, fp_products,
                 nbytes, time_it=True, raw_only=False, int_ops=0,
                 plain_timed=None) -> dict:
    """One kernel against its plain version on the same inputs; raises
    unless they agree after canonical, or, with ``raw_only``, unless the raw
    limbs are equal. The bound counts its Fp products and ``int_ops`` other
    32-bit integer operations. ``plain_timed``, where given, is the plain
    version timed in place of ``run_plain`` (K5: compared with its segment
    model, timed as accum_plain). Returns the kernels-line entry."""
    got = run_kernel()
    torch.cuda.synchronize()
    want = run_plain()
    raw, canon, err = compare(torch, got, want)
    if not canon or (raw_only and not raw):
        raise AssertionError(f"{label}: kernel != plain (raw limbs equal {raw}, "
                             f"after canonical {canon}, max |limb diff| {err})")
    entry = {
        "name": kernel.name, "route": kernel.route, "source": kernel.source,
        "replaces": kernel.replaces, "variant": label, "launches": None,
        "max_abs_err": err, "match": canon, "match_raw": raw,
        "fp_products": fp_products, "int_ops": int_ops, "bytes": nbytes,
        "library_ms": None,
    }
    if time_it:
        entry["ms"] = median_ms(torch, run_kernel, KERNEL_REPS, warmup=1)
        entry["device_ms"] = device_ms(torch, run_kernel, DEVICE_REPS, warmup=1)
        entry["plain_ms"] = median_ms(torch, plain_timed or run_plain, PLAIN_REPS,
                                      warmup=0)
    log(f"{label}: equal to plain after canonical {canon}, raw limbs {raw}"
        + (f"; kernel per call {entry['ms']:.4f} ms, device-only "
           f"{entry['device_ms']:.4f} ms, plain {entry['plain_ms']:.1f} ms"
           if time_it else ""))
    return entry


def coop_report(entry: dict, label: str, plan) -> tuple[int, int]:
    """Log a block-per-lane kernel's rounds per lane (ops/coop.py), the
    shared memory its wrapper hands the launch and its measured time per
    round; return (product rounds, add rounds). The kernels-line entry
    keeps only measured numbers, so none of these go into it."""
    from lighthouse_tpu_torch.ops import coop

    prod, add, products = coop.rounds_per_lane(plan)
    log(f"{label}: one block of {coop.THREADS} threads per lane, "
        f"{coop.shared_bytes(plan)} B of dynamic shared memory; per lane "
        f"{prod} product rounds and {add} add rounds ({products} Fp products, "
        f"which one thread ran in a row); {entry['ms']:.4f} ms = "
        f"{entry['ms'] * 1e3 / (prod + add):.4f} us per round")
    return prod, add


def round_costs(a: tuple, b: tuple) -> tuple[float, float]:
    """(us per product round, us per add round) solving time = product
    rounds x p + add rounds x q for two block-per-lane kernels, each given
    as (ms, (product rounds, add rounds))."""
    (ta, (p1, q1)), (tb, (p2, q2)) = a, b
    t1, t2 = ta * 1e3, tb * 1e3
    det = p1 * q2 - p2 * q1
    return (t1 * q2 - t2 * q1) / det, (p1 * t2 - p2 * t1) / det


def check_fused_kernels(torch, np, sets, hashes) -> dict:
    """Every fused kernel against its plain version at the fused path's
    shapes; returns {kernel name: kernels-line entry}."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.curve import g1_generator
    from lighthouse_tpu_torch.ops import coop, field, pairing, points, tower
    from lighthouse_tpu_torch.ops import tkernel_calls as tc
    from lighthouse_tpu_torch.ops.points import FP2_OPS, FP_OPS

    c = fp_product_counts(P)
    n = len(sets)
    rng = np.random.default_rng(2026)
    dev = torch.device("cuda")

    def cuda(arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)

    x1, y1, inf1 = points.g1_to_dev([s.signing_keys[0].point for s in sets])
    x2, y2, inf2 = points.g2_to_dev([s.signature.point for s in sets])
    inf1[5] = inf2[7] = True
    scal = [2 * int(k) + 1 for k in rng.integers(0, 1 << 63, n, dtype=np.int64)]
    scal[:4] = [0, 1, (1 << 64) - 1, 1 << 40]
    bits_np = points.scalars_to_bits(scal, 64)
    x1, y1, inf1_t, x2, y2, inf2_t, bits = cuda((x1, y1, inf1, x2, y2, inf2, bits_np))
    out = {}

    # K3: [k]Q for G1 keys and G2 signatures, raw limbs; then the edge
    # lanes: scalars 0 and 2^64 - 1, single one bits at the top, above the
    # middle and at the bottom, and a base at infinity under 2^64 - 1
    edge_scal = [0, (1 << 64) - 1, 1 << 63, 1 << 40, 1, (1 << 64) - 1]
    edge_inf = np.arange(len(edge_scal)) == 5
    ebits, einf = cuda((points.scalars_to_bits(edge_scal, 64), edge_inf))
    for g, F, x, y, inf, inf_np, kern, coord in (
            ("g1", FP_OPS, x1, y1, inf1_t, inf1, tc.K3_G1, 192),
            ("g2", FP2_OPS, x2, y2, inf2_t, inf2, tc.K3_G2, 384)):
        fn = tc.scalar_mul_g1 if g == "g1" else tc.scalar_mul_g2
        products = scalar_mul_products(np, c, g, inf_np, bits_np)
        out[kern.name] = check_kernel(
            torch, kern, f"K3 scalar_mul_{g} {n} lanes",
            lambda: fn(x, y, inf, bits),
            lambda: points.pt_scalar_mul_bits(F, (x, y), inf, bits),
            products, n * (2 * coord + 1 + 64 * 4 + 3 * coord), raw_only=True)
        lanes = k3_lanes_per_warp(tc, g == "g2", n)
        warp_report(torch, out[kern.name], f"K3 {g} {n} lanes",
                    scalar_mul_rounds(np, inf_np, bits_np, lanes),
                    max(scalar_mul_products(np, c, g, inf_np[i:i + 1], bits_np[i:i + 1])
                        for i in range(n)),
                    lambda: fn(x, y, inf, bits), warp_shape(lanes))
        ex, ey = x[8:8 + len(edge_scal)], y[8:8 + len(edge_scal)]
        check_kernel(torch, kern, f"K3 scalar_mul_{g} {len(edge_scal)} edge lanes",
                     lambda: fn(ex, ey, einf, ebits),
                     lambda: points.pt_scalar_mul_bits(F, (ex, ey), einf, ebits),
                     0, 0, time_it=False, raw_only=True)

    # K2: Jacobian inputs from K3's plain outputs (random Z, lane 0 and 5/7
    # at infinity) with one lane at Z = 1; then the edge lanes. Its Fp
    # products besides the divstep inversion: G1 the product by R^3 and 4
    # (zi^2, X zi^2, zi^3, Y zi^3); G2 the norm's 2, R^3, the conjugate's
    # 2, and an Fp2 square and 3 Fp2 products. Fermat's chain (the TPU
    # kernel's, and K2's before) is kept as its own bound.
    zero, p_raw = field.ints_to_limbs([0])[0], field.ints_to_limbs([P])[0]
    one, minus_one = field.ints_to_limbs_mont([1, P - 1])
    for g, F, x, y, inf, kern, coord in (
            ("g1", FP_OPS, x1, y1, inf1_t, tc.K2_G1, 192),
            ("g2", FP2_OPS, x2, y2, inf2_t, tc.K2_G2, 384)):
        J = [t.clone() for t in points.pt_scalar_mul_bits(F, (x, y), inf, bits)]
        lane_one = points.pt_from_affine(F, x[10:11], y[10:11])
        for t, v in zip(J, lane_one):
            t[10:11] = v
        fn = tc.to_affine_g1 if g == "g1" else tc.to_affine_g2
        products = 5 if g == "g1" else 16
        fermat = c["inv"] + 4 if g == "g1" else c["fp2_inv"] + 11
        # the fused path launches G1 at S lanes, G2 at S (the hash) and 1
        for m in ((n,) if g == "g1" else (n, 1)):
            P_ = tuple(t[3:3 + m] if m == 1 else t for t in J)
            e = check_kernel(
                torch, kern, f"K2 to_affine_{g} {m} lanes",
                lambda: fn(P_), lambda: points.pt_to_affine(F, P_),
                m * products, m * (3 * coord + 2 * coord + 1),
                int_ops=m * gcd_inverse_ops(), raw_only=True)
            e["fermat_products"] = m * fermat
            e["host_ms"] = host_ms(torch, lambda: fn(P_))
            log(f"K2 to_affine_{g} {m} lanes: host enqueue "
                f"{e['host_ms'] * 1e3:.2f} us per call")
            out[kern.name] = e
        # edge lanes: Z = 0, Z = p (the lazy zero), Z = Montgomery one,
        # Z in [p, 2p) (the same point), Z = p - 1 in Montgomery form
        E = [t[20:25].cpu().clone() for t in J]
        z = E[2] if g == "g1" else E[2][:, 0]
        if g == "g2":
            E[2][:, 1] = 0
        lazy = field.limbs_to_int(z[3].numpy())
        z[3] = torch.from_numpy(field.ints_to_limbs([lazy + P if lazy < P else lazy])[0])
        for lane, v in enumerate((zero, p_raw, one, None, minus_one)):
            if v is not None:
                z[lane] = torch.from_numpy(v)
        E = tuple(t.cuda() for t in E)
        check_kernel(torch, kern, f"K2 to_affine_{g} 5 edge lanes",
                     lambda: fn(E), lambda: points.pt_to_affine(F, E), 0, 0,
                     time_it=False, raw_only=True)
        if fn(E)[2].tolist() != [True, True, False, False, False]:
            raise AssertionError(f"K2 {g}: the edge lanes' infinity flags")

    # K4: 96 signatures in G2, 28 on-curve points outside G2, 4 at infinity
    sx, sy, sinf = k4_lanes(np, sets)
    sx, sy, sinf_t = cuda((sx, sy, sinf))
    k4_products = subgroup_fast_products(c)
    out[tc.K4.name] = check_kernel(
        torch, tc.K4, f"K4 subgroup_fast {n} lanes",
        lambda: tc.subgroup_check_g2_fast(sx, sy, sinf_t),
        lambda: points.subgroup_check_g2_fast(sx, sy, sinf_t),
        int((~sinf).sum()) * k4_products, n * (2 * 384 + 2))
    warp_report(torch, out[tc.K4.name], f"K4 {n} lanes", K4_ROUNDS, k4_products,
                lambda: tc.subgroup_check_g2_fast(sx, sy, sinf_t),
                warp_shape(subgroup_lanes_per_warp(tc, n)))
    # K15, the full-order check [r]Q == inf, on the same lanes: the NAF
    # of r, 255 doublings and 59 mixed additions of Q or -Q (the plain
    # version's binary chain: 254 doublings, 133 complete additions)
    k15_products = subgroup_full_products(c)
    out[tc.K15.name] = check_kernel(
        torch, tc.K15, f"K15 subgroup_full {n} lanes",
        lambda: tc.subgroup_check_g2(sx, sy, sinf_t),
        lambda: points.pt_subgroup_check(
            FP2_OPS, points.pt_from_affine(FP2_OPS, sx, sy, sinf_t)),
        int((~sinf).sum()) * k15_products, n * (2 * 384 + 2))
    warp_report(torch, out[tc.K15.name], f"K15 {n} lanes", K15_ROUNDS, k15_products,
                lambda: tc.subgroup_check_g2(sx, sy, sinf_t),
                warp_shape(subgroup_lanes_per_warp(tc, n)))
    fast = tc.subgroup_check_g2_fast(sx, sy, sinf_t)
    before = tc.K15.launches
    full = tc.subgroup_check_g2(sx, sy, sinf_t)
    out[tc.K15.name]["check_launches"] = tc.K15.launches - before
    want = [True] * 96 + [False] * 28 + [True] * 4
    if not torch.equal(fast, full) or fast.tolist() != want:
        raise AssertionError("K4 disagrees with K15 (the full-order check) or "
                             "the expected membership pattern")
    log("K4 agrees with K15, the full-order check [r]Q == inf, on the card on "
        "96 points in G2, 28 outside G2 and 4 at infinity")

    # K8: S + 1 = 129 pairs, P at infinity on lane 3, Q on lane 125, both
    # on lane 64; raw limbs
    g1 = g1_generator().neg()
    px, py, pinf = points.g1_to_dev([s.signing_keys[0].point for s in sets] + [g1])
    qx, qy, qinf = points.g2_to_dev(hashes + [sets[0].signature.point])
    pinf[3] = qinf[125] = True
    pinf[64] = qinf[64] = True
    px, py, pinf_t, qx, qy, qinf_t = cuda((px, py, pinf, qx, qy, qinf))
    live = int((~(pinf | qinf)).sum())
    out[tc.K8.name] = check_kernel(
        torch, tc.K8, f"K8 miller {n + 1} lanes",
        lambda: tc.miller_loop((px, py), pinf_t, (qx, qy), qinf_t),
        lambda: tc.miller_loop_seg((px, py), pinf_t, (qx, qy), qinf_t),
        live * (63 * (c["fp12_sqr"] + c["dbl_step"] + c["sparse"])
                + 5 * (c["add_step"] + c["sparse"])),
        (n + 1) * (2 * 192 + 2 * 384 + 2 + 2304), raw_only=True)
    k8_rounds = coop_report(out[tc.K8.name], "K8", coop.miller_plan())
    f = tc.miller_loop_seg((px, py), pinf_t, (qx, qy), qinf_t)

    # K9-K11 at 1 lane (the path's) and 8 lanes, on Miller outputs. K9's
    # bound: its plan's Fp products, the product by R^3 and the divstep
    # inversion's operations; Fermat's chain (its plain version's, and K9's
    # before) is kept as its own bound
    k9_plan = coop.easy_exp_plan()
    k9 = coop.rounds_per_lane(k9_plan)[2] + 1
    k9_fermat = c["fp12_inv"] + 2 * c["fp12_mul"] + 2 * c["fp12_frob"]
    k10 = 63 * c["fp12_sqr"] + 5 * c["fp12_mul"]
    k10_rounds = {}
    k11 = {"b": c["fp12_frob"] + c["fp12_mul"],
           "c": 2 * c["fp12_frob"] + 2 * c["fp12_mul"],
           "final": c["fp12_sqr"] + 2 * c["fp12_mul"]}
    for m in (1, 8):
        fm = f[:m].contiguous()
        # K9 raw against its plan's model (the divstep inversion's
        # representative), then after canonical against its plain version
        check_kernel(torch, tc.K9, f"K9 easy_exp {m} lanes against its plan",
                     lambda: tc.easy_exp(fm), lambda: coop.easy_exp_steps(fm),
                     0, 0, time_it=False, raw_only=True)
        e = check_kernel(torch, tc.K9, f"K9 easy_exp {m} lanes",
                         lambda: tc.easy_exp(fm), lambda: tc.easy_exp_plain(fm),
                         m * k9, m * 2 * 2304, int_ops=m * gcd_inverse_ops())
        e["fermat_products"] = m * k9_fermat
        if m == 1:
            out[tc.K9.name] = e
            coop_report(e, "K9 (one divstep inversion between its two programs)",
                        k9_plan)
        g = tc.easy_exp_plain(fm)
        for xm1 in (True, False):
            e = check_kernel(
                torch, tc.K10, f"K10 pow_x xm1={xm1} {m} lanes",
                lambda: tc.pow_x(g, xm1), lambda: tc.pow_x_plain(g, xm1),
                m * (k10 + (c["fp12_mul"] if xm1 else 0)), m * 2 * 2304,
                raw_only=True)
            if m == 1:
                k10_rounds[xm1] = (e["ms"], coop_report(e, f"K10 xm1={xm1}",
                                                        coop.pow_x_plan(xm1)))
            if m == 1 and xm1:
                out[tc.K10.name] = e
        u = tc.pow_x_plain(g, False)
        for mode in tc.COMB_MODES:
            e = check_kernel(
                torch, tc.K11, f"K11 comb {mode} {m} lanes",
                lambda: tc.comb(u, g, mode), lambda: tc.comb_plain(u, g, mode),
                m * k11[mode], m * 3 * 2304, raw_only=True)
            if m == 1:
                coop_report(e, f"K11 {mode}", coop.comb_plan(mode))
            if m == 1 and mode == "c":
                out[tc.K11.name] = e

    product_us, add_us = round_costs((out[tc.K8.name]["ms"], k8_rounds),
                                     k10_rounds[False])
    log(f"one product round {product_us:.4f} us, one add round {add_us:.4f} us "
        f"(K8's and K10's (x) times fitted to their rounds per lane)")

    # the chain from K10 on, on the plain K9's output, raw against the plain
    # chain; then the 9-launch chain, K9 included, against the plain chain
    # and the classic path after canonical
    f1 = f[:1].contiguous()
    g = tc.easy_exp_plain(f1)

    def hard_part(pow_x, comb):
        a = pow_x(pow_x(g, True), True)
        b = comb(pow_x(a, False), a, "b")
        cc = comb(pow_x(pow_x(b, False), False), b, "c")
        return comb(cc, g, "final")

    plain = hard_part(tc.pow_x_plain, tc.comb_plain)
    r0, _, _ = compare(torch, hard_part(tc.pow_x, tc.comb), plain)
    if not r0:
        raise AssertionError("K10-K11 on the plain K9's output disagree with the "
                             "plain chain in their raw limbs")
    got = tc.final_exp_kernel(f1)
    classic = pairing.final_exponentiation(f1)
    r1, c1, _ = compare(torch, got, plain)
    r2, c2, _ = compare(torch, got, classic)
    one = [bool(tower.fp12_is_one(v)) for v in (got, plain, classic)]
    if not (c1 and c2) or len(set(one)) != 1:
        raise AssertionError("final_exp_kernel disagrees with the plain chain "
                             "or pairing.final_exponentiation after canonical")
    log(f"K10-K11 (8 launches) on the plain K9's output: raw limbs of the plain "
        f"chain {r0}; final_exp_kernel (9 launches): equal to the plain chain "
        f"after canonical {c1} (raw {r1}) and to pairing.final_exponentiation "
        f"after canonical {c2} (raw {r2}), fp12_is_one {one[0]} on all three")
    return out


# -------------------------------------------------- phase 5: MSM kernels


def seeded_scalars(np, seed: int, n: int):
    """n nonzero uniform 64-bit scalars from a seeded generator: the
    distribution of the backend's CSPRNG scalars, made reproducible."""
    r = np.frombuffer(np.random.default_rng(seed).bytes(8 * n), np.uint64).copy()
    r[r == 0] = 1
    return r


def msm_edge_batch(np, sets):
    """The batch's signatures and seeded scalars with the MSM's edge cases:
    set 1 carries set 0's signature and shares its window-0 digit (the mixed
    addition doubles), set 3 carries -sig_2 and shares window 1's digit with
    sets 2 and 4 (the bucket cancels to infinity, then takes a further
    addition), and no scalar has the digit 15 in window 15 (lane 239 stays
    empty). Returns (signature points, scalars uint64)."""
    rng = np.random.default_rng(4)
    pts = [s.signature.point for s in sets]
    pts[1] = pts[0]
    pts[3] = pts[2].neg()
    r = rng.integers(1, 1 << 60, len(pts), dtype=np.int64).astype(np.uint64)
    top = rng.integers(0, 15, len(pts), dtype=np.int64).astype(np.uint64)
    r |= top << np.uint64(60)             # window 15's digit below 15
    low = np.uint64(0xFF)
    r[0] = (r[0] & ~low) | np.uint64(0x35)
    r[1] = (r[1] & ~low) | np.uint64(0x45)  # window 0: digit 5, as set 0
    for i in (2, 3, 4):
        r[i] = (r[i] & ~low) | np.uint64(0x70 + i)  # window 1: digit 7
    return pts, r


def oracle_msm(pts, r, skip):
    """sum r_i P_i over the sets not skipped, in the oracle's arithmetic."""
    from lighthouse_tpu_torch.crypto.bls.curve import g2_infinity

    acc = g2_infinity()
    for p, k, sk in zip(pts, r, skip):
        if not sk:
            acc = acc.add(p.mul(int(k)))
    return acc


def horner_edge_windows(torch):
    """Window sums (X, Y, Z) [256, 2, 48] on which K7 takes every leg of
    the complete addition: T[15] = aG and T[14] = 16aG (acc == T[14]: the
    doubling), T[13] = -512aG (acc == -T[13]: Z3 = 0), T[12] at infinity
    onto the accumulator at infinity, T[11] onto it, T[10] at infinity
    (acc kept), T[9] == T[8]. The windows at infinity keep a point's X and
    Y under Z = 0; lanes 16-255 are zero."""
    from lighthouse_tpu_torch.crypto.bls.curve import g2_generator
    from lighthouse_tpu_torch.ops import points

    g, a = g2_generator(), 3
    pts = [g.mul(11 + w) for w in range(16)]
    pts[15], pts[14], pts[13] = g.mul(a), g.mul(16 * a), g.mul(512 * a).neg()
    pts[11] = g.mul(5)
    pts[9] = pts[8] = g.mul(7)
    x, y, _ = points.g2_to_dev(pts)
    J = points.pt_from_affine(points.FP2_OPS, torch.from_numpy(x), torch.from_numpy(y))
    T = tuple(torch.zeros(256, 2, 48, dtype=torch.int32) for _ in range(3))
    for t, v in zip(T, J):
        t[:16] = v
    T[2][[10, 12]] = 0
    return T


def tree_edge_buckets(torch):
    """Bucket lanes (X, Y, Z) [256, 2, 48] on which K6 takes every leg of
    the complete addition: window 0 wholly at infinity (a point's X and Y
    under Z = 0), window 1 with five buckets at infinity, window 2 with
    equal lanes (rows 0 and 1 the same limbs, rows 2 and 3 the same point
    under another Z: step 1 doubles), window 3 with opposite lanes (rows 1
    and 5 the negations of rows 0 and 4, row 5 under another Z: step 1
    cancels to Z = 0), the other windows seeded points; the pad lanes
    (row 15) all-zero limbs. Row j of window w is lane j * 16 + w."""
    import numpy as np

    from lighthouse_tpu_torch.crypto.bls.curve import g2_generator
    from lighthouse_tpu_torch.ops import points

    def lane(w, j):
        return j * 16 + w

    g = g2_generator()
    rng = np.random.default_rng(11)
    pts = [g.mul(int(k)) for k in rng.integers(2, 1 << 30, 240)]
    pts[lane(2, 1)] = pts[lane(2, 0)]
    pts[lane(2, 3)] = pts[lane(2, 2)]
    pts[lane(3, 1)] = pts[lane(3, 0)].neg()
    pts[lane(3, 5)] = pts[lane(3, 4)].neg()
    x, y, _ = points.g2_to_dev(pts)
    F = points.FP2_OPS
    X, Y, Z = (c.clone() for c in points.pt_from_affine(
        F, torch.from_numpy(x), torch.from_numpy(y)))
    for i in (lane(2, 3), lane(3, 5)):  # (x z^2, y z^3, z)
        z = X[i + 1:i + 2]
        z2 = F.sqr(z)
        X[i:i + 1], Y[i:i + 1], Z[i:i + 1] = (
            F.mul(X[i:i + 1], z2), F.mul(Y[i:i + 1], F.mul(z2, z)), z)
    for i in [lane(0, j) for j in range(15)] + [lane(1, j) for j in (1, 3, 4, 5, 14)]:
        Z[i] = 0
    pad = torch.zeros(16, 2, 48, dtype=torch.int32)
    return tuple(torch.cat([c, pad]).contiguous() for c in (X, Y, Z))


# K5's segments per bucket, each on a group of K5_GROUP threads
# (csrc/msm.cu kPackedGroup), every block within 256 threads
K5_GROUP = 8
K5_SEGMENTS = (1, 2, 4, 8, 16, 32)


def k5_shape_name(segments: int) -> str:
    """threads per group x segments per bucket"""
    return f"{K5_GROUP}x{segments}"


def k5_shaped(torch, msm, segments: int, sx, sy, idx, valid):
    """K5 at a given number of segments through the library's
    lh_msm_accum_shaped (not counted: the smoke's comparison of shapes)."""
    import ctypes

    from lighthouse_tpu_torch.ops import _build

    out = torch.empty((3, 256, 2, 48), dtype=torch.int32, device=sx.device)
    rc = msm.K5.library.load().lh_msm_accum_shaped(
        ctypes.c_int(segments),
        *(ctypes.c_void_p(t.data_ptr()) for t in (sx, sy, idx, valid, *out)),
        ctypes.c_int(idx.shape[0]), ctypes.c_int(sx.shape[0]), ctypes.c_longlong(256),
        ctypes.c_void_p(_build.current_stream(sx)))
    if rc:
        raise RuntimeError(f"lh_msm_accum_shaped({segments}): CUDA error {rc}")
    return out[0], out[1], out[2]


def k5_segment_work(np, msm, c: dict, valid, k: int) -> tuple[int, int]:
    """(Fp products, rounds on the slowest group) of K5 cut into k segments
    (k = 1: unsplit) for this schedule: a mixed addition for each point of
    a segment after its first (the first lands on infinity), a complete
    addition for each join of two nonempty sums; the slowest group's
    mixed additions and its bucket's log2 k join levels at 6 rounds each.
    Counted for points in general position, as random signatures and
    scalars give."""
    import torch

    want = msm.segment_bounds(torch.from_numpy(np.ascontiguousarray(valid)), k)[2].numpy()
    adds = np.maximum(want - 1, 0)
    products = int(adds.sum()) * c["madd_g2"]
    live = want > 0
    step = 1
    while step < k:
        both = live[0::2 * step] & live[step::2 * step]
        products += int(both.sum()) * c["add_g2"]
        live[0::2 * step] |= live[step::2 * step]
        step *= 2
    rounds = int(adds.max()) * ADD_ROUNDS + (k.bit_length() - 1) * ADD_ROUNDS
    return products, rounds


def same_points(torch, tc, P, Q) -> bool:
    """Lane for lane the same point at canonical affine (K2 G2 on both)."""
    return all(torch.equal(a, b) for a, b in zip(tc.to_affine_g2(P), tc.to_affine_g2(Q)))


def k5_shape_sweep(torch, np, sets, sizes=(128, 512, 2048, 4096, 8192),
                   turns: int = 5) -> dict:
    """K5 at S = n sets (n points [k_i] sig_(i mod 128) made on the card,
    seeded scalars, L = max_rounds(n)) at each segment count: equal to
    accum_plain at canonical affine; device-only in ``turns`` turns, the
    shapes in alternating order, the median kept beside the spread; the
    shape the launch takes, the fastest measured, the deepest bucket and
    each shape's rounds on its slowest group. Returns {n: {...}}."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import msm, points
    from lighthouse_tpu_torch.ops import tkernel_calls as tc

    c = fp_product_counts(P)
    dev = torch.device("cuda")
    base_x, base_y, _ = points.g2_to_dev([s.signature.point for s in sets])
    res = {}
    for n in sizes:
        rng = np.random.default_rng(n)
        rows = np.arange(n) % len(sets)
        ks = [int(k) for k in rng.integers(1, 1 << 62, n, dtype=np.int64)]
        none = torch.zeros(n, dtype=torch.bool, device=dev)
        bx = torch.from_numpy(base_x[rows]).to(dev)
        by = torch.from_numpy(base_y[rows]).to(dev)
        kb = torch.from_numpy(points.scalars_to_bits(ks, 64)).to(dev)
        sx, sy, _ = tc.to_affine_g2(tc.scalar_mul_g2(bx, by, none, kb))
        L = msm.max_rounds(n)
        idx, valid = msm.build_schedule(seeded_scalars(np, n + 1, n), L)
        ti = torch.from_numpy(idx).to(dev)
        tv = torch.from_numpy(valid).to(dev)
        want = msm.accum_plain(sx, sy, ti, tv)
        runs = {}
        for shape in K5_SEGMENTS:
            def run(shape=shape):
                return k5_shaped(torch, msm, shape, sx, sy, ti, tv)
            if not same_points(torch, tc, run(), want):
                raise AssertionError(f"K5 at S={n}, shape {shape}, != accum_plain "
                                     "at canonical affine")
            runs[shape] = run
        if not same_points(torch, tc, msm.accumulate(sx, sy, ti, tv), want):
            raise AssertionError(f"K5 wrapper at S={n} != accum_plain at canonical affine")
        times = {shape: [] for shape in K5_SEGMENTS}
        for turn in range(turns):
            order = K5_SEGMENTS if turn % 2 == 0 else K5_SEGMENTS[::-1]
            for shape in order:
                times[shape].append(device_ms(torch, runs[shape], DEVICE_REPS, warmup=1))
        auto = msm.accum_segments(L)
        counts = valid.sum(0)
        row = {"L": L, "bucket_max": int(counts.max()), "bucket_mean": float(counts.mean()),
               "launch": k5_shape_name(auto)}
        for shape in K5_SEGMENTS:
            ms = statistics.median(times[shape])
            products, rounds = k5_segment_work(np, msm, c, valid, shape)
            row[k5_shape_name(shape)] = {"device_ms": ms, "device_ms_turns": times[shape],
                                         "rounds": rounds, "us_per_round": ms * 1e3 / rounds,
                                         "fp_products": products}
        fastest = min(K5_SEGMENTS, key=lambda sh: row[k5_shape_name(sh)]["device_ms"])
        row["fastest"] = k5_shape_name(fastest)
        res[n] = row
        log(f"K5 at S={n} (L={L}, deepest bucket {row['bucket_max']}), every shape "
            f"equal to accum_plain at canonical affine; the launch takes "
            f"{row['launch']} (threads per group x segments), the fastest median "
            f"measured {row['fastest']}; device-only: {json.dumps(row)}")
    return res


def check_msm_kernels(torch, np, sets) -> dict:
    """K5, K6 and K7 against their plain versions on the card at the main
    path's shapes (the batch's 128 signatures, seeded scalars, L = 48), on
    every lane after canonical (K7 raw on its one lane); then on the edge
    batch, with every set skipped, and K7 on the edge windows; the MSM
    point against the scan (K3 G2, the
    S-leaf tree) at canonical affine after K2, and against the oracle's
    sum_i r_i S_i on a subset of 8 sets. Returns {kernel name: entry}."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.ops import msm, points
    from lighthouse_tpu_torch.ops import tkernel_calls as tc

    c = fp_product_counts(P)
    n = len(sets)
    dev = torch.device("cuda")
    L = msm.max_rounds(n)

    def cuda(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays)

    sx, sy, _ = points.g2_to_dev([s.signature.point for s in sets])
    r = seeded_scalars(np, 2027, n)
    idx, valid = msm.build_schedule(r, L)
    sx, sy, ti, tv = cuda(sx, sy, idx, valid)
    work = msm_products(np, c, valid)
    out = {}
    # K5 at the launch's segments, raw against its segment model (accum_plain
    # itself when unsplit), then against accum_plain at canonical affine.
    # Its bound counts the function's work (msm_products); the split's
    # segments and joins go into its rounds and the warp_report line.
    k = msm.accum_segments(L)
    k5_products, k5_rounds = k5_segment_work(np, msm, c, valid, k)
    out[msm.K5.name] = check_kernel(
        torch, msm.K5, f"K5 msm_accum {n} sets, L={L}, 256 lanes, "
        f"{k5_shape_name(k)} (threads per group x segments)",
        lambda: msm.accumulate(sx, sy, ti, tv),
        lambda: msm.accum_segments_plain(sx, sy, ti, tv, k),
        work["msm_accum"], n * 2 * 384 + L * 240 * 5 + 3 * 256 * 384, raw_only=True,
        plain_timed=lambda: msm.accum_plain(sx, sy, ti, tv))
    B = msm.accum_plain(sx, sy, ti, tv)
    if not same_points(torch, tc, msm.accumulate(sx, sy, ti, tv), B):
        raise AssertionError("K5 != accum_plain at canonical affine")
    warp_report(torch, out[msm.K5.name], "K5", k5_rounds, k5_products,
                lambda: msm.accumulate(sx, sy, ti, tv),
                f"a bucket as {k} segments on groups of {K5_GROUP} threads, "
                f"joined in {k.bit_length() - 1} levels; equal to accum_plain at "
                "canonical affine")
    out[msm.K6.name] = check_kernel(
        torch, msm.K6, "K6 msm_tree 256 lanes",
        lambda: msm.tree(B), lambda: msm.tree_plain(B),
        work["msm_tree"], 2 * 3 * 256 * 384, raw_only=True)
    warp_report(torch, out[msm.K6.name], "K6", tree_rounds(np, valid), work["msm_tree"],
                lambda: msm.tree(B), "a block per window, a lane on a group of 16 threads")
    T = msm.tree_plain(B)
    out[msm.K7.name] = check_kernel(
        torch, msm.K7, "K7 msm_horner lane 0",
        lambda: msm.horner(T), lambda: msm.horner_plain(T),
        work["msm_horner"], 16 * 3 * 384 + 3 * 384, raw_only=True)
    warp_report(torch, out[msm.K7.name], "K7", horner_rounds(c, work["msm_horner"]),
                work["msm_horner"], lambda: msm.horner(T))
    log(f"K5 schedule at S={n}: L={L}, points per bucket max "
        f"{int(valid.sum(0).max())}, mean {valid.sum(0).mean():.2f}")

    # the MSM point against the scan at canonical affine (K2 G2 after both)
    bits = torch.from_numpy(points.scalars_to_bits([int(k) for k in r], 64)).to(dev)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    got = tc.to_affine_g2(tuple(t[None] for t in msm.msm_g2(sx, sy, ti, tv)))
    scan = points.pt_tree_sum(points.FP2_OPS, tc.scalar_mul_g2(sx, sy, none, bits), n)
    want = tc.to_affine_g2(tuple(t[None] for t in scan))
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("MSM (K5-K7) != scan (K3 G2 + tree) at canonical affine")
    log(f"MSM (K5-K7) equals the scan (K3 G2, {n}-leaf tree) at canonical affine")

    # edge cases, every kernel against its plain version, then the oracle
    pts, re = msm_edge_batch(np, sets)
    ex, ey, _ = points.g2_to_dev(pts)
    ex, ey = cuda(ex, ey)
    sub = np.arange(n) >= 8
    for label, skip in (("edge batch", None), ("edge batch, 8 sets", sub),
                        ("every set skipped", np.ones(n, bool))):
        sched = msm.build_schedule(re, L, skip)
        ei, ev = cuda(*sched)
        EB = msm.accum_plain(ex, ey, ei, ev)
        models = {}
        for shape in K5_SEGMENTS:  # every shape, raw against its model
            models[shape] = msm.accum_segments_plain(ex, ey, ei, ev, shape)
            check_kernel(torch, msm.K5, f"K5 {label}, shape {k5_shape_name(shape)}",
                         lambda: k5_shaped(torch, msm, shape, ex, ey, ei, ev),
                         lambda: models[shape], 0, 0, time_it=False, raw_only=True)
            if not same_points(torch, tc, k5_shaped(torch, msm, shape, ex, ey, ei, ev), EB):
                raise AssertionError(f"K5 {label}, shape {shape}: != accum_plain at "
                                     "canonical affine")
        check_kernel(torch, msm.K5, f"K5 {label}", lambda: msm.accumulate(ex, ey, ei, ev),
                     lambda: models[k], 0, 0, time_it=False, raw_only=True)
        check_kernel(torch, msm.K6, f"K6 {label}", lambda: msm.tree(EB),
                     lambda: msm.tree_plain(EB), 0, 0, time_it=False, raw_only=True)
        ET = msm.tree_plain(EB)
        check_kernel(torch, msm.K7, f"K7 {label}", lambda: msm.horner(ET),
                     lambda: msm.horner_plain(ET), 0, 0, time_it=False,
                     raw_only=True)
        ax, ay, ainf = tc.to_affine_g2(tuple(t[None] for t in msm.msm_g2(ex, ey, ei, ev)))
        if skip is not None:
            (pt,) = points.g2_from_dev(ax, ay, ainf)
            if pt != oracle_msm(pts, re, skip):
                raise AssertionError(f"MSM ({label}) != the oracle's sum r_i S_i")
            log(f"MSM ({label}) equals the oracle's sum r_i S_i")
    if not bool(ainf[0]):
        raise AssertionError("MSM with every set skipped is not infinity")
    WT = tuple(t.to(dev) for t in horner_edge_windows(torch))
    check_kernel(torch, msm.K7, "K7 edge windows", lambda: msm.horner(WT),
                 lambda: msm.horner_plain(WT), 0, 0, time_it=False, raw_only=True)
    EB = tuple(t.to(dev) for t in tree_edge_buckets(torch))
    check_kernel(torch, msm.K6, "K6 edge buckets", lambda: msm.tree(EB),
                 lambda: msm.tree_plain(EB), 0, 0, time_it=False, raw_only=True)
    return out


def msm_against_scan(torch, np, sets, n: int) -> dict:
    """Kernel-only times at S = n sets: the MSM (K5 at L = max_rounds(n),
    K6, K7) against the scan (K3 G2 at n lanes, then the n-leaf plain tree),
    by CUDA events; the two points agree at canonical affine. The n points
    are [k_i] sig_(i mod 128) made on the card (K3 G2, K2 G2)."""
    from lighthouse_tpu_torch.ops import msm, points
    from lighthouse_tpu_torch.ops import tkernel_calls as tc

    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    base_x, base_y, _ = points.g2_to_dev([s.signature.point for s in sets])
    rows = np.arange(n) % len(sets)
    ks = [int(k) for k in rng.integers(1, 1 << 62, n, dtype=np.int64)]
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    bx = torch.from_numpy(base_x[rows]).to(dev)
    by = torch.from_numpy(base_y[rows]).to(dev)
    kb = torch.from_numpy(points.scalars_to_bits(ks, 64)).to(dev)
    sx, sy, _ = tc.to_affine_g2(tc.scalar_mul_g2(bx, by, none, kb))
    r = seeded_scalars(np, n + 1, n)
    L = msm.max_rounds(n)
    idx, valid = msm.build_schedule(r, L)
    ti = torch.from_numpy(idx).to(dev)
    tv = torch.from_numpy(valid).to(dev)
    bits = torch.from_numpy(points.scalars_to_bits([int(k) for k in r], 64)).to(dev)

    def run_msm():
        return msm.msm_g2(sx, sy, ti, tv)

    def run_scan():
        return points.pt_tree_sum(points.FP2_OPS, tc.scalar_mul_g2(sx, sy, none, bits), n)

    a = tc.to_affine_g2(tuple(t[None] for t in run_msm()))
    b = tc.to_affine_g2(tuple(t[None] for t in run_scan()))
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        raise AssertionError(f"MSM != scan at S={n}")
    got = tc.scalar_mul_g2(sx, sy, none, bits)
    if not all(torch.equal(x, y) for x, y in zip(
            got, points.pt_scalar_mul_bits(points.FP2_OPS, (sx, sy), none, bits))):
        raise AssertionError(f"K3 G2 != pt_scalar_mul_bits in its raw limbs at {n} lanes")
    B = msm.accumulate(sx, sy, ti, tv)
    if not all(torch.equal(x, y) for x, y in zip(msm.tree(B), msm.tree_plain(B))):
        raise AssertionError(f"K6 != tree_plain in its raw limbs at S={n}")
    res = {
        "S": n, "L": L, "bucket_max": int(valid.sum(0).max()),
        "msm_ms": median_ms(torch, run_msm, KERNEL_REPS, warmup=1),
        "k5_ms": median_ms(torch, lambda: msm.accumulate(sx, sy, ti, tv), KERNEL_REPS, warmup=1),
        "k6_ms": median_ms(torch, lambda: msm.tree(B), KERNEL_REPS, warmup=1),
        "k6_device_ms": device_ms(torch, lambda: msm.tree(B), DEVICE_REPS, warmup=1),
        "k7_ms": median_ms(torch, lambda: msm.horner(B), KERNEL_REPS, warmup=1),
        "scan_ms": median_ms(torch, run_scan, KERNEL_REPS, warmup=1),
        "k3_g2_ms": median_ms(torch, lambda: tc.scalar_mul_g2(sx, sy, none, bits),
                              KERNEL_REPS, warmup=1),
        "k3_g2_device_ms": device_ms(torch, lambda: tc.scalar_mul_g2(sx, sy, none, bits),
                                     DEVICE_REPS, warmup=1),
    }
    log(f"MSM vs scan at S={n} (kernel-only, CUDA events, median of "
        f"{KERNEL_REPS}; K3 G2 and K6 also device-only), equal at canonical affine, "
        f"K3 G2 and K6 raw-equal to their plain versions: {json.dumps(res)}")
    return res


# ------------------------------------------------- phase 6: hash kernels


def hash_edge_inputs(torch, np, msgs):
    """Edge lanes of the hash: u = 0 on both halves, u0 == u1 (Q0 + Q1
    takes the doubling), then the RFC 9380 J.10.1 messages under their DST."""
    from lighthouse_tpu_torch.ops import htc

    u = htc.hash_to_field_dev(msgs[:1])
    twin = np.repeat(u[:, :1], 2, axis=1)
    rfc = htc.hash_to_field_dev(list(RFC_J10_1), RFC_DST)
    return torch.from_numpy(np.concatenate([np.zeros_like(u), twin, rfc])).cuda()


def check_hash_kernels(torch, np, sets, hashes) -> dict:
    """K12, K13 and K14 against their plain versions on the card, at the
    shapes the 128 distinct messages of the batch give them (K12 at 128
    lanes, K13 at the chained route's 256 u-halves, K14 at 128) and on the
    edge lanes; the device hash, resident and chained, against the oracle's
    points and the RFC vectors. Returns {kernel name: kernels-line entry}."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2
    from lighthouse_tpu_torch.ops import htc, points, tower
    from lighthouse_tpu_torch.ops import tkernel_calls as tc
    from lighthouse_tpu_torch.ops import tkernel_htc as th

    c = fp_product_counts(P)
    msgs = [s.message for s in sets]
    n = len(msgs)
    t0 = time.perf_counter()
    us_np = htc.hash_to_field_dev(msgs)
    log(f"hash_to_field_dev (host) for {n} messages: "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")
    us = torch.from_numpy(us_np).cuda()

    A, B, Z, cands = htc.sswu_derived_constants()
    e = htc.SQRT_RATIO_E
    consts = (A, B, Z, cands, Z.pow(1 + e), e)
    work = [[sswu_lane_work(Fq2(*tower.fp2_from_dev(us_np[i, j])), consts)
             for j in range(2)] for i in range(n)]
    squares = sum(w[0] for row in work for w in row)
    if not 0 < squares < 2 * n:
        raise AssertionError("the batch's u-halves do not cover both SSWU branches")
    log(f"SSWU branches over the {2 * n} u-halves: gx1 square on {squares}, "
        f"non-square on {2 * n - squares}; candidate checks "
        f"{sum(w[1] for row in work for w in row)}")
    k13_products = sum(sswu_products(c, w) for row in work for w in row)
    out = {}

    for line in ptxas_summary(th.K12.library.build_log):
        log(f"ptxas htc.cu: {line}")
    out[th.K12.name] = check_kernel(
        torch, th.K12, f"K12 map_to_g2 {n} lanes",
        lambda: th.map_to_g2_resident(us), lambda: th.map_to_g2_resident_plain(us),
        k13_products + n * (c["add_g2"] + c["cofactor"]), n * (768 + 3 * 384),
        raw_only=True)
    flat = torch.cat([us[:, 0], us[:, 1]])
    out[th.K13.name] = check_kernel(
        torch, th.K13, f"K13 sswu_iso {2 * n} lanes",
        lambda: th.sswu_iso(flat), lambda: th.sswu_iso_plain(flat),
        k13_products, 2 * n * (384 + 3 * 384), raw_only=True)
    J = th.sswu_iso_plain(flat)
    Q = points.pt_add(points.FP2_OPS, tuple(t[:n] for t in J), tuple(t[n:] for t in J))
    out[th.K14.name] = check_kernel(
        torch, th.K14, f"K14 cofactor {n} lanes",
        lambda: th.clear_cofactor(Q), lambda: th.cofactor_plain(Q),
        n * c["cofactor"], n * 2 * 3 * 384, raw_only=True)
    k12_rounds = max(map_rounds(row) for row in work)
    k13_rounds = max(sswu_rounds(w) for row in work for w in row)
    log(f"K12: one warp per message, {th.WARPS_PER_BLOCK} warp per block, "
        f"{th.THREADS_PER_MESSAGE} threads per message (a half-warp of "
        f"{th.THREADS_PER_MESSAGE // 2} per u-half until Q0 + Q1, then the warp); "
        f"K13 a half-warp per u (two per block), K14 a warp per point. Rounds "
        f"of the slowest lane: K12 {k12_rounds} ({out[th.K12.name]['ms'] * 1e3 / k12_rounds:.4f} "
        f"us per round), K13 {k13_rounds} "
        f"({out[th.K13.name]['ms'] * 1e3 / k13_rounds:.4f} us), K14 {COFACTOR_ROUNDS} "
        f"({out[th.K14.name]['ms'] * 1e3 / COFACTOR_ROUNDS:.4f} us); one thread "
        f"ran up to {max(sum(sswu_products(c, w) for w in row) for row in work) + c['add_g2'] + c['cofactor']} "
        f"Fp products in a row per message before")

    # edge lanes: each kernel against its plain version, not timed
    edge = hash_edge_inputs(torch, np, msgs)
    m = edge.shape[0]
    check_kernel(torch, th.K12, f"K12 map_to_g2 {m} edge lanes",
                 lambda: th.map_to_g2_resident(edge),
                 lambda: th.map_to_g2_resident_plain(edge), 0, 0, time_it=False,
                 raw_only=True)
    # an odd count leaves the last block's second half-warp without a u
    eflat = torch.cat([edge[:, 0], edge[:, 1]])[:-1]
    check_kernel(torch, th.K13, f"K13 sswu_iso {2 * m - 1} edge lanes",
                 lambda: th.sswu_iso(eflat), lambda: th.sswu_iso_plain(eflat),
                 0, 0, time_it=False, raw_only=True)
    EJ = th.sswu_iso_plain(torch.cat([edge[:, 0], edge[:, 1]]))
    EQ = tuple(t.clone() for t in points.pt_add(
        points.FP2_OPS, tuple(t[:m] for t in EJ), tuple(t[m:] for t in EJ)))
    EQ[2][2] = 0  # a lane at infinity
    check_kernel(torch, th.K14, f"K14 cofactor {m} edge lanes",
                 lambda: th.clear_cofactor(EQ), lambda: th.cofactor_plain(EQ),
                 0, 0, time_it=False,
                 raw_only=True)

    # the RFC vectors through K12 and K2
    x, y, inf = tc.to_affine_g2(th.map_to_g2_resident(edge[2:]))
    x, y, inf = x.cpu().numpy(), y.cpu().numpy(), inf.cpu().numpy()
    for i, (ex, ey) in enumerate(RFC_J10_1.values()):
        if inf[i] or tower.fp2_from_dev(x[i]) != ex or tower.fp2_from_dev(y[i]) != ey:
            raise AssertionError(f"K12 + K2 miss RFC 9380 J.10.1 vector {i}")
    log(f"K12 + K2 give the {len(RFC_J10_1)} RFC 9380 J.10.1 points")

    # the device hash of the batch's 128 messages, resident and chained,
    # against the oracle's points (canonical affine limbs)
    want = points.g2_to_dev(hashes)
    for resident in (True, False):
        got = th.hash_to_g2_fused_dev(msgs, resident=resident)
        for g, w in zip(got, want):
            if not np.array_equal(g.cpu().numpy(), w):
                raise AssertionError(f"device hash (resident={resident}) != oracle")
    log(f"device hash of the {n} messages, resident and chained, equals the "
        "oracle's hash_to_g2 at canonical affine")
    return out


# ----------------------------------------------------- phases 6-8: paths


def run_verify(torch, backend, sets, label: str, must, must_not=()):
    """One verify with every kernel count zeroed just before it and read
    just after; the kernels in ``must`` have to run, those in ``must_not``
    may not."""
    from lighthouse_tpu_torch.ops import _build

    _build.reset_launches()
    torch.cuda.synchronize()
    with GpuSampler() as gpu:
        t0 = time.perf_counter()
        ok = backend.verify_signature_sets(sets)
        seconds = time.perf_counter() - t0
    launches = {k.name: k.launches for k in _build.KERNELS}
    sizes = {k.name: k.sizes.copy() for k in _build.KERNELS}
    dev = backend.last_operand_device
    log(f"{label}: verdict {ok} in {seconds:.3f} s; stages "
        f"{json.dumps({k: round(v, 4) for k, v in backend.last_stage_seconds.items()})}; "
        f"operands on {dev}; kernel launches {json.dumps(launches)}; "
        f"nvidia-smi over the verify {json.dumps(gpu.summary)}")
    if dev is None or dev.type != "cuda":
        raise AssertionError(f"{label}: operands were on {dev}, not the card")
    for name in must:
        if launches[name] <= 0:
            raise AssertionError(f"{label}: kernel {name} was never launched")
    for name in must_not:
        if launches[name]:
            raise AssertionError(f"{label}: kernel {name} ran on this path")
    return ok, {"seconds": seconds, "launches": launches, "sizes": sizes,
                "stages": dict(backend.last_stage_seconds), "gpu": gpu.summary}


def verify_path(torch, sets, label: str, options: dict, must, must_not,
                swap: bool = True) -> dict:
    """The valid batch (and the swapped one) through one configuration of
    ``TorchBackend(**options)``."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.torch_backend import TorchBackend

    be = TorchBackend(**options)
    S, K = len(sets), len(sets[0].signing_keys)
    ok, valid = run_verify(torch, be, sets, f"{label} valid S={S} K={K}", must, must_not)
    if ok is not True:
        raise AssertionError(f"{label}: the valid batch did not verify")
    runs = {"valid": valid}
    if swap:
        ok, runs["poisoned"] = run_verify(torch, be, swapped(api, sets),
                                          f"{label} signatures swapped", must, must_not)
        if ok is not False:
            raise AssertionError(f"{label}: the batch with swapped signatures verified")
    log(f"{label}: {valid['seconds']:.3f} s per batch of {S} sets "
        f"({S / valid['seconds']:.2f} sets/s)")
    return runs


def swapped(api, sets):
    bad = list(sets)
    bad[0] = api.SignatureSet(sets[1].signature, sets[0].signing_keys, sets[0].message)
    bad[1] = api.SignatureSet(sets[0].signature, sets[1].signing_keys, sets[1].message)
    return bad


def small_batches(torch, sets, paths) -> dict:
    """Every configuration on the same two small batches, against the
    oracle. Returns each configuration's run of the valid small batch."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.torch_backend import TorchBackend

    small = sets[:2]
    small_bad = [sets[0], swapped(api, sets)[1]]
    runs = {}
    for label, batch in (("small", small), ("small tampered", small_bad)):
        want = api.verify_signature_sets_python(batch)
        for name, (options, must, must_not) in paths.items():
            got, run = run_verify(
                torch, TorchBackend(**options), batch,
                f"{name} {label} S=2 K={len(batch[0].signing_keys)}", must, must_not)
            if got is not want:
                raise AssertionError(f"{name} {label}: port says {got}, oracle {want}")
            runs.setdefault(name, run)
    log(f"small batches: {', '.join(paths)} agree with the pure-Python oracle "
        "(True, False)")
    return runs


# ----------------------------------------------------------------- main


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(repo, "lighthouse_tpu_torch")):
        print("chip_smoke: lighthouse_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, repo)
    # importing the wrappers registers K1, the fused, MSM and hash kernels
    from lighthouse_tpu_torch.ops import _build, mont_mul, msm
    from lighthouse_tpu_torch.ops import tkernel_calls as tc
    from lighthouse_tpu_torch.ops import tkernel_htc as th

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; "
        f"nvidia-smi: {smi}")
    probe_product(torch, np, build(torch))

    k1 = check_mont_mul(torch, np, N_VALUES, REPS)

    t0 = time.perf_counter()
    sets, hashes = build_batch(np, N_SETS, N_KEYS, seed=7)
    log(f"batch of S={N_SETS} sets x K={N_KEYS} keys built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    with GpuSampler() as gpu:
        fused = check_fused_kernels(torch, np, sets, hashes)
        msm_entries = check_msm_kernels(torch, np, sets)
        fused.update(msm_entries)
        wide = msm_against_scan(torch, np, sets, 2048)
        k5_sweep = k5_shape_sweep(torch, np, sets)
        sweep = k3_lane_sweep(torch, np, sets)
        k4_sweep = subgroup_lane_sweep(torch, np, sets, "fast", K4_SWEEP)
        k15_sweep = subgroup_lane_sweep(torch, np, sets, "full", K15_SWEEP)
        fused.update(check_hash_kernels(torch, np, sets, hashes))
    clock_mhz = gpu.summary["sm_clock_mhz_max"]
    int_rate = INT_MADS_PER_CLOCK * clock_mhz * 1e6
    log(f"SM clock over the kernel checks: max {clock_mhz} MHz (mean "
        f"{gpu.summary['sm_clock_mhz']}); 32-bit integer multiply-add rate "
        f"132 SMs x 64 x clock = {int_rate:.4g}/s")

    # Each configuration's kernels: the fused verify kernels K2, K3 G1, K4,
    # K8-K11; the signature accumulator K5-K7 (MSM) or K3 G2 (scan); the
    # hash kernels K12 (resident) or K13 and K14 (chained); K1 always. No
    # verify launches K15.
    k1_name = mont_mul.K1.name
    hash_names = [th.K12.name, th.K13.name, th.K14.name]
    msm_names = [msm.K5.name, msm.K6.name, msm.K7.name]
    scan_name, k15_name = tc.K3_G2.name, tc.K15.name
    verify_names = [k.name for k in _build.KERNELS
                    if k.name not in [k1_name, scan_name, k15_name,
                                      *msm_names, *hash_names]]
    chained = [th.K13.name, th.K14.name]
    never = [k15_name]
    paths = {
        "fused": ({}, [k1_name, *verify_names, *msm_names, th.K12.name],
                  [*chained, scan_name, *never]),
        "fused scan": ({"msm": False}, [k1_name, *verify_names, scan_name, th.K12.name],
                       [*chained, *msm_names, *never]),
        "fused chained-hash": ({"htc_resident": False},
                               [k1_name, *verify_names, *msm_names, *chained],
                               [th.K12.name, scan_name, *never]),
        "fused host-hash": ({"device_htc": False}, [k1_name, *verify_names, *msm_names],
                            [*hash_names, scan_name, *never]),
        "classic host-hash": ({"fused": False, "device_htc": False}, [k1_name],
                              verify_names + msm_names + hash_names + [scan_name, *never]),
    }
    # the main path: the card's default, the fused verify with the device
    # hash and the MSM, which launches each MSM kernel once
    fused_runs = verify_path(torch, sets, "fused", *paths["fused"])
    for run in fused_runs.values():
        if any(run["launches"][name] != 1 for name in msm_names):
            raise AssertionError(f"the MSM kernels did not run once each: "
                                 f"{[run['launches'][m] for m in msm_names]}")
        # the block-per-lane kernels: the Miller loop once, the x-power five
        # times (the 9-launch final exponentiation)
        if (run["launches"][tc.K8.name], run["launches"][tc.K10.name]) != (1, 5):
            raise AssertionError(
                f"K8 and K10 launched {run['launches'][tc.K8.name]} and "
                f"{run['launches'][tc.K10.name]} times, not 1 and 5")
    # the same batches with the scan, then the host hash and the classic path
    scan_runs = verify_path(torch, sets, "fused scan", *paths["fused scan"])
    host_runs = verify_path(torch, sets, "fused host-hash", *paths["fused host-hash"],
                            swap=False)
    classic_runs = verify_path(torch, sets, "classic host-hash",
                               *paths["classic host-hash"])
    small = small_batches(torch, sets, paths)
    log(f"per verify of S={N_SETS} x K={N_KEYS}: fused {fused_runs['valid']['seconds']:.3f} s "
        f"(device hash, MSM; swapped {fused_runs['poisoned']['seconds']:.3f} s), "
        f"fused {scan_runs['valid']['seconds']:.3f} s (device hash, scan; swapped "
        f"{scan_runs['poisoned']['seconds']:.3f} s), "
        f"fused {host_runs['valid']['seconds']:.3f} s (host hash, MSM), "
        f"classic {classic_runs['valid']['seconds']:.3f} s (host hash)")

    # launches from the run of the path each kernel belongs to: the main
    # path's; the scan's for K3 G2; the chained hash's small batch for K13
    # and K14; the K4-against-K15 check for K15
    launches = dict(fused_runs["valid"]["launches"])
    launches[scan_name] = scan_runs["valid"]["launches"][scan_name]
    for name in chained:
        launches[name] = small["fused chained-hash"]["launches"][name]
    launches[k15_name] = fused[k15_name].pop("check_launches")
    launches_path = {scan_name: f"fused scan (msm=False) valid S={N_SETS}",
                     k15_name: "chip_smoke K4-against-K15 check (no verify launches it)",
                     **{name: "fused chained-hash small S=2" for name in chained}}
    time_at_path_shape(torch, np, k1, fused_runs["valid"]["sizes"][k1_name], REPS)
    entries = [k1] + [fused[n] for n in verify_names + [scan_name, k15_name]
                      + msm_names + hash_names]
    for e in entries:
        e["launches"] = launches[e["name"]]
        if e["name"] in launches_path:
            e["launches_path"] = launches_path[e["name"]]
        bytes_ms = e.pop("bytes") / HBM_BYTES_PER_S * 1e3
        ops_ms = (e.pop("fp_products") * MADS_PER_FP_PRODUCT
                  + e.pop("int_ops", 0)) / int_rate * 1e3
        e["bound_ms"] = max(bytes_ms, ops_ms)
        e["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        if "fermat_products" in e:  # K2, K9: the bound of the Fermat chain replaced
            fermat_ms = max(bytes_ms, e.pop("fermat_products")
                            * MADS_PER_FP_PRODUCT / int_rate * 1e3)
            log(f"{e['name']}: bound {e['bound_ms']:.6f} ms by its divsteps "
                f"(device-only {e['device_ms']:.4f} ms); Fermat's chain, which it "
                f"replaced, {fermat_ms:.6f} ms")
    # the device time of one default verify, estimated: K1 at each of its
    # sizes, every other kernel at the shape it was timed at, times its
    # launches on the main path; from the device-only times (K1 L2-warm,
    # as the glue has just written its operands, and L2-cold), and from
    # the per-call times (which hold the host's enqueue) as before
    main_launches = fused_runs["valid"]["launches"]
    per_kernel = {e["name"]: e["device_ms"] * main_launches[e["name"]]
                  for e in entries[1:] if main_launches[e["name"]]}
    device_total = k1["path_total_device_ms"] + sum(per_kernel.values())
    device_cold = k1["path_total_device_cold_ms"] + sum(per_kernel.values())
    per_call_total = k1["path_total_ms"] + sum(
        e["ms"] * main_launches[e["name"]] for e in entries[1:])
    log(f"device time per default verify ~{device_total:.3f} ms from the "
        f"device-only times, ~{device_cold:.3f} ms with K1 L2-cold (K1 "
        f"{k1['path_total_device_ms']:.4f} ms L2-warm, "
        f"{k1['path_total_device_cold_ms']:.4f} ms L2-cold over its sizes, host "
        f"enqueue {k1['path_total_host_ms']:.4f} ms beside it; the "
        f"others at their timed shapes x their launches on the main path: "
        f"{json.dumps({k: round(v, 4) for k, v in per_kernel.items()})}); "
        f"~{per_call_total:.3f} ms from the per-call times")
    log(f"MSM against the scan at S={wide['S']}: MSM {wide['msm_ms']:.4f} ms "
        f"(K5 {wide['k5_ms']:.4f}, K6 {wide['k6_ms']:.4f}, device-only "
        f"{wide['k6_device_ms']:.4f}, K7 {wide['k7_ms']:.4f}), "
        f"scan {wide['scan_ms']:.4f} ms (K3 G2 {wide['k3_g2_ms']:.4f})")
    log("K5 device-only ms at S sets by shape (threads per group x segments; "
        "the launch's shape, the fastest measured): " + "; ".join(
            f"S={n} L={v['L']} " + ", ".join(
                f"{k5_shape_name(sh)} {v[k5_shape_name(sh)]['device_ms']:.4f}"
                for sh in K5_SEGMENTS) + f" ({v['launch']}, {v['fastest']})"
            for n, v in k5_sweep.items()))
    log("K3 device-only ms at n lanes, one warp per lane / packed (the "
        "launch's lanes per warp): " + ", ".join(
            f"{k} {v['one_warp']['device_ms']:.4f} / {v['packed']['device_ms']:.4f} "
            f"({v['lanes_per_warp']})" for k, v in sweep.items()))
    log("K4 device-only ms at n lanes, one warp per lane / packed / one thread "
        "per lane (the launch's lanes per warp, the fastest measured): " + ", ".join(
            f"{n} " + " / ".join(f"{v[k]['device_ms']:.4f}" for k in K4_SHAPES)
            + f" ({v['lanes_per_warp']}, {v['fastest']})" for n, v in k4_sweep.items()))
    log("K15 device-only ms at n lanes, one warp per lane / packed / one thread "
        "per lane (the launch's lanes per warp, the fastest measured): " + ", ".join(
            f"{n} " + " / ".join(f"{v[k]['device_ms']:.4f}" for k in K4_SHAPES)
            + f" ({v['lanes_per_warp']}, {v['fastest']})" for n, v in k15_sweep.items()))
    log(f"smoke wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
