#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lighthouse_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run: S=128 sets x K=512 keys

In order, and failing (nonzero exit, no result line) at the first fault:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every registered kernel from the sources in this checkout, one
   nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card: bit equality
   on 2^20 random values in [0, 2p) plus the edge rows, big-int agreement on
   a sample, and timings (CUDA events, median of repetitions);
4. the main path through the user entry point
   ``TorchBackend().verify_signature_sets`` at a mainnet block's size:
   S=128 aggregate attestations of K=512 keys. A valid batch must verify
   True, the same batch with two signatures swapped False, and a small batch
   must agree with the pure-Python oracle. Kernel launch counts are zeroed
   just before each verify and read just after: every kernel must have run;
5. the ``kernels`` JSON line, the nvidia-smi line, and the result line.

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

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, at its 700 W limit
FP32_OPS_PER_S = 67e12      # H100 SXM data sheet, non-tensor float32 rate

N_SETS, N_KEYS = 128, 512   # a mainnet block's aggregate attestations
N_VALUES = 1 << 20          # products in the kernel-vs-plain check
REPS = 20                   # timed repetitions per kernel measurement


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def median_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Median device time of fn() over reps runs, by CUDA events."""
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


def random_fp(np, rng, n: int):
    """n random values in [0, 2p) as int32 [n, 48] byte limbs: uniform low
    bytes, top byte below 0x34 (2p's top byte is 0x34)."""
    limbs = rng.integers(0, 256, size=(n, 48), dtype=np.int32)
    limbs[:, 47] = rng.integers(0, 0x34, size=n, dtype=np.int32)
    return limbs


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

    kernel_ms = median_ms(torch, lambda: mont_mul.mont_mul_cuda(ta, tb), reps)
    plain_ms = median_ms(torch, plain, max(3, reps // 4), warmup=1)
    bytes_ms = 576 * n_values / HBM_BYTES_PER_S * 1e3
    # 12x12 word products for a*b, 12x12 for m*p, 12 for m: 300 32x32->64
    # multiplies, each two 32-bit multiply-adds (low and high halves),
    # counted at the non-tensor float32 rate (the table has no int32 row).
    ops_ms = 600 * n_values / FP32_OPS_PER_S * 1e3
    log(f"mont_mul: {n_values} products, bit-equal to plain: {match}, "
        f"big-int sample of {len(rows)} rows ok; kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {max(bytes_ms, ops_ms):.4f} ms")
    return {
        "name": mont_mul.K1.name,
        "route": mont_mul.K1.route,
        "source": mont_mul.K1.source,
        "replaces": mont_mul.K1.replaces,
        "launches": None,   # filled from the main path's run
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes a Montgomery product
        "n": n_values,
        "match": match,
    }


def time_at_path_shape(torch, np, entry: dict, reps: int) -> None:
    """Kernel vs plain at the product count the verify path launched K1
    with most often (bit equality and times)."""
    from lighthouse_tpu_torch.ops import mont_mul

    n, count = entry["path_sizes"].most_common(1)[0]
    rng = np.random.default_rng(n)
    ta = torch.from_numpy(random_fp(np, rng, n)).cuda()
    tb = torch.from_numpy(random_fp(np, rng, n)).cuda()
    if not torch.equal(mont_mul.mont_mul_cuda(ta, tb),
                       mont_mul.mont_mul_plain(ta, tb)):
        raise AssertionError(f"mont_mul kernel != plain at n={n}")
    entry["path_n"] = n
    entry["path_n_launches"] = count
    entry["path_ms"] = median_ms(torch, lambda: mont_mul.mont_mul_cuda(ta, tb), reps * 10)
    entry["path_plain_ms"] = median_ms(
        torch, lambda: mont_mul.mont_mul_plain(ta, tb), reps * 2)
    entry["path_bound_ms"] = 576 * n / HBM_BYTES_PER_S * 1e3
    log(f"mont_mul at the verify path's most common size n={n} "
        f"({count} launches): kernel {entry['path_ms']:.4f} ms, "
        f"plain {entry['path_plain_ms']:.4f} ms")


# ----------------------------------------------------- phase 4: main path


def build_batch(np, n_sets: int, n_keys: int, seed: int):
    """S sets of K keys: sk_i = base + i, pk_{i+1} = pk_i + G1; set s
    signs message m_s with the sum of its keys' secrets."""
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
    sets = []
    for s in range(n_sets):
        msg = hashlib.sha256(rng.bytes(32) + s.to_bytes(4, "little")).digest()
        lo = s * n_keys
        sk_sum = (n_keys * base + n_keys * lo + n_keys * (n_keys - 1) // 2) % R
        sig = api.AggregateSignature(hash_to_g2(msg).mul(sk_sum))
        sets.append(api.SignatureSet(sig, pks[lo:lo + n_keys], msg))
    return sets


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
            "power_w": statistics.mean(r[2] for r in rows) if rows else None,
        }
        return False


def run_verify(torch, backend, sets, label: str) -> tuple[bool, dict]:
    """One verify with every kernel count zeroed just before it and read
    just after."""
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
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{label}: kernel {name} was never launched")
    return ok, {"seconds": seconds, "launches": launches, "sizes": sizes,
                "stages": dict(backend.last_stage_seconds), "gpu": gpu.summary}


def main_path(torch, np, n_sets: int, n_keys: int) -> dict:
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.torch_backend import TorchBackend

    t0 = time.perf_counter()
    sets = build_batch(np, n_sets, n_keys, seed=7)
    log(f"batch of S={n_sets} sets x K={n_keys} keys built on the host in "
        f"{time.perf_counter() - t0:.1f} s")
    be = TorchBackend()

    ok, valid = run_verify(torch, be, sets, f"valid S={n_sets} K={n_keys}")
    if ok is not True:
        raise AssertionError("the valid batch did not verify")

    bad = list(sets)
    bad[0] = api.SignatureSet(sets[1].signature, sets[0].signing_keys, sets[0].message)
    bad[1] = api.SignatureSet(sets[0].signature, sets[1].signing_keys, sets[1].message)
    ok, poisoned = run_verify(torch, be, bad, "signatures swapped")
    if ok is not False:
        raise AssertionError("the batch with swapped signatures verified")

    small = sets[:2]
    small_bad = [sets[0], bad[1]]
    for label, batch in (("small", small), ("small tampered", small_bad)):
        want = api.verify_signature_sets_python(batch)
        got, _ = run_verify(torch, be, batch, f"{label} S=2 K={n_keys}")
        if got is not want:
            raise AssertionError(f"{label}: port says {got}, oracle {want}")
    log("small batches agree with the pure-Python oracle (True, False)")
    return {"valid": valid, "poisoned": poisoned}


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
    from lighthouse_tpu_torch.ops import _build, mont_mul  # noqa: F401  (registers K1)

    smi = nvidia_smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; "
        f"nvidia-smi: {smi}")

    seconds = _build.build_all()
    log(f"built {len(_build.KERNELS)} kernel(s) in {seconds:.1f} s: "
        + ", ".join(k.library.path.name for k in _build.KERNELS))

    entry = check_mont_mul(torch, np, N_VALUES, REPS)
    runs = main_path(torch, np, N_SETS, N_KEYS)
    entry["launches"] = runs["valid"]["launches"][entry["name"]]
    entry["path_sizes"] = runs["valid"]["sizes"][entry["name"]]
    time_at_path_shape(torch, np, entry, REPS)
    top = entry.pop("path_sizes").most_common(6)
    log(f"verify: {runs['valid']['seconds']:.3f} s per batch of {N_SETS} "
        f"sets ({N_SETS / runs['valid']['seconds']:.2f} sets/s); K1 "
        f"launches per verify {entry['launches']}; commonest K1 sizes "
        f"(products: launches) {dict(top)}")

    print(json.dumps({"kernels": [entry]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
