#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (lighthouse_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the full run: S=128 sets x K=512 keys

In order, and failing (nonzero exit, no result line) at the first fault:

1. environment: torch and CUDA versions, the card's name and power limit;
2. build: every registered kernel from the sources in this checkout, one
   nvcc per source, all started together; the seconds of each build and
   each kernel's registers, spills and stack from ``ptxas -v``;
3. K1 against its plain PyTorch version: bit equality on 2^20 random values
   in [0, 2p) plus the edge rows, big-int agreement on a sample, timings
   (CUDA events, median of repetitions);
4. each fused kernel (K2-K4, K8-K11) against its plain version on the card,
   at the shapes the fused path gives it and with its edge lanes (infinity,
   Z = 1, scalars 0, 1 and 2^64-1, points outside G2): equality after
   ``canonical`` (and whether the raw limbs match), K4 also against the
   full-order subgroup check, the final-exponentiation chain also against
   the classic ``pairing.final_exponentiation``; kernel and plain times;
5. the fused path, the card's default, through the user entry point
   ``TorchBackend().verify_signature_sets`` at a mainnet block's size:
   S=128 aggregate attestations of K=512 keys. The valid batch must verify
   True, the batch with two signatures swapped False, two small batches
   must agree with the pure-Python oracle;
6. the classic path (``TorchBackend(fused=False)``) on the same valid and
   swapped batches, and both paths on the same small batches, against the
   oracle;
7. the ``kernels`` JSON line, the nvidia-smi line, and the result line.

Kernel launch counts are zeroed just before each verify and read just after
it. Each path has its own list: the fused path must launch every kernel
(K1-K4, K8-K11), the classic path K1 and none of the fused kernels.

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
PLAIN_REPS = 3              # of a plain version (launch-bound, seconds)


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


def build(torch) -> None:
    from lighthouse_tpu_torch.ops import _build

    seconds = _build.build_all()
    log(f"built {len(seconds)} libraries for {len(_build.KERNELS)} kernels, "
        f"nvcc seconds from the common start: {json.dumps(seconds)}")
    for lib in {id(k.library): k.library for k in _build.KERNELS}.values():
        for line in ptxas_summary(lib.build_log):
            log(f"ptxas {lib.source.name}: {line}")


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

    kernel_ms = median_ms(torch, lambda: mont_mul.mont_mul_cuda(ta, tb), reps)
    plain_ms = median_ms(torch, plain, max(3, reps // 4), warmup=1)
    log(f"mont_mul: {n_values} products, bit-equal to plain: {match}, "
        f"big-int sample of {len(rows)} rows ok; kernel {kernel_ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    return {
        "name": mont_mul.K1.name,
        "route": mont_mul.K1.route,
        "source": mont_mul.K1.source,
        "replaces": mont_mul.K1.replaces,
        "launches": None,   # filled from the main path's run
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bytes": 576 * n_values,
        "fp_products": n_values,
        "library_ms": None,  # no single PyTorch call computes a Montgomery product
        "n": n_values,
        "match": match,
        "match_raw": match,
    }


def time_at_path_shape(torch, np, entry: dict, sizes, reps: int) -> None:
    """K1 vs plain at the product count the fused path launched K1 with
    most often (bit equality and times)."""
    from lighthouse_tpu_torch.ops import mont_mul

    n, count = sizes.most_common(1)[0]
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
    log(f"mont_mul at the fused path's most common size n={n} "
        f"({count} launches): kernel {entry['path_ms']:.4f} ms, "
        f"plain {entry['path_plain_ms']:.4f} ms; commonest sizes "
        f"(products: launches) {dict(sizes.most_common(6))}")


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
    return c


def scalar_mul_products(np, c: dict, g: str, inf, bits) -> int:
    """K3's Fp products for these lanes: 64 doublings each, and a mixed
    addition on each one bit after the first (the first adds to infinity,
    which returns at once); lanes at infinity add nothing."""
    ones = bits.sum(axis=1)
    adds = np.where(inf | (ones == 0), 0, ones - 1).sum()
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
                 nbytes, time_it=True) -> dict:
    """One kernel against its plain version on the same inputs; raises
    unless they agree after canonical. Returns the kernels-line entry."""
    got = run_kernel()
    torch.cuda.synchronize()
    want = run_plain()
    raw, canon, err = compare(torch, got, want)
    if not canon:
        raise AssertionError(f"{label}: kernel != plain (max |limb diff| {err})")
    entry = {
        "name": kernel.name, "route": kernel.route, "source": kernel.source,
        "replaces": kernel.replaces, "variant": label, "launches": None,
        "max_abs_err": err, "match": canon, "match_raw": raw,
        "fp_products": fp_products, "bytes": nbytes, "library_ms": None,
    }
    if time_it:
        entry["ms"] = median_ms(torch, run_kernel, KERNEL_REPS, warmup=1)
        entry["plain_ms"] = median_ms(torch, run_plain, PLAIN_REPS, warmup=0)
    log(f"{label}: equal to plain after canonical {canon}, raw limbs {raw}"
        + (f"; kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.1f} ms"
           if time_it else ""))
    return entry


def check_fused_kernels(torch, np, sets, hashes) -> dict:
    """Every fused kernel against its plain version at the fused path's
    shapes; returns {kernel name: kernels-line entry}."""
    from lighthouse_tpu_torch.crypto.bls.constants import P
    from lighthouse_tpu_torch.crypto.bls.curve import g1_generator
    from lighthouse_tpu_torch.crypto.bls.fields import Fq2
    from lighthouse_tpu_torch.crypto.bls.hash_to_curve import map_to_curve_g2
    from lighthouse_tpu_torch.ops import pairing, points
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
    scal[:3] = [0, 1, (1 << 64) - 1]
    bits_np = points.scalars_to_bits(scal, 64)
    x1, y1, inf1_t, x2, y2, inf2_t, bits = cuda((x1, y1, inf1, x2, y2, inf2, bits_np))
    out = {}

    # K3: [k]Q for G1 keys and G2 signatures
    for g, F, x, y, inf, inf_np, kern, coord in (
            ("g1", FP_OPS, x1, y1, inf1_t, inf1, tc.K3_G1, 192),
            ("g2", FP2_OPS, x2, y2, inf2_t, inf2, tc.K3_G2, 384)):
        fn = tc.scalar_mul_g1 if g == "g1" else tc.scalar_mul_g2
        out[kern.name] = check_kernel(
            torch, kern, f"K3 scalar_mul_{g} {n} lanes",
            lambda: fn(x, y, inf, bits),
            lambda: points.pt_scalar_mul_bits(F, (x, y), inf, bits),
            scalar_mul_products(np, c, g, inf_np, bits_np),
            n * (2 * coord + 1 + 64 * 4 + 3 * coord))

    # K2: Jacobian inputs from K3's plain outputs (random Z, lane 0 and 5/7
    # at infinity) with one lane at Z = 1
    for g, F, x, y, inf, kern, coord in (
            ("g1", FP_OPS, x1, y1, inf1_t, tc.K2_G1, 192),
            ("g2", FP2_OPS, x2, y2, inf2_t, tc.K2_G2, 384)):
        J = [t.clone() for t in points.pt_scalar_mul_bits(F, (x, y), inf, bits)]
        one = points.pt_from_affine(F, x[10:11], y[10:11])
        for t, v in zip(J, one):
            t[10:11] = v
        fn = tc.to_affine_g1 if g == "g1" else tc.to_affine_g2
        inv = c["inv"] + 4 if g == "g1" else c["fp2_inv"] + 11
        # the fused path launches G1 at S lanes, G2 at one
        for m in ((n,) if g == "g1" else (n, 1)):
            P_ = tuple(t[3:3 + m] if m == 1 else t for t in J)
            out[kern.name] = check_kernel(
                torch, kern, f"K2 to_affine_{g} {m} lanes",
                lambda: fn(P_), lambda: points.pt_to_affine(F, P_),
                m * inv, m * (3 * coord + 2 * coord + 1))

    # K4: 96 signatures in G2, 28 on-curve points outside G2, 4 at infinity
    pts = [s.signature.point for s in sets[:96]]
    pts += [map_to_curve_g2(Fq2(s + 2, 3 * s + 1)) for s in range(28)]
    pts += [s.signature.point for s in sets[124:128]]
    sx, sy, sinf = points.g2_to_dev(pts)
    sinf[124:] = True
    sx, sy, sinf_t = cuda((sx, sy, sinf))
    out[tc.K4.name] = check_kernel(
        torch, tc.K4, f"K4 subgroup_fast {n} lanes",
        lambda: tc.subgroup_check_g2_fast(sx, sy, sinf_t),
        lambda: points.subgroup_check_g2_fast(sx, sy, sinf_t),
        int((~sinf).sum()) * (63 * c["dbl_g2"] + 5 * c["madd_g2"]
                              + 4 * c["fp2_mul"] + c["fp2_sqr"] + 2 * c["fp2_mul"]),
        n * (2 * 384 + 2))
    fast = tc.subgroup_check_g2_fast(sx, sy, sinf_t)
    full = points.pt_subgroup_check(FP2_OPS, points.pt_from_affine(FP2_OPS, sx, sy, sinf_t))
    want = [True] * 96 + [False] * 28 + [True] * 4
    if not torch.equal(fast, full) or fast.tolist() != want:
        raise AssertionError("K4 disagrees with the full-order check or the "
                             "expected membership pattern")
    log("K4 agrees with the full-order check [r]Q == inf on 96 points in G2, "
        "28 outside G2 and 4 at infinity")

    # K8: S + 1 = 129 pairs, P at infinity on lane 3, Q on lane 125
    g1 = g1_generator().neg()
    px, py, pinf = points.g1_to_dev([s.signing_keys[0].point for s in sets] + [g1])
    qx, qy, qinf = points.g2_to_dev(hashes + [sets[0].signature.point])
    pinf[3] = qinf[125] = True
    px, py, pinf_t, qx, qy, qinf_t = cuda((px, py, pinf, qx, qy, qinf))
    live = int((~(pinf | qinf)).sum())
    out[tc.K8.name] = check_kernel(
        torch, tc.K8, f"K8 miller {n + 1} lanes",
        lambda: tc.miller_loop((px, py), pinf_t, (qx, qy), qinf_t),
        lambda: tc.miller_loop_seg((px, py), pinf_t, (qx, qy), qinf_t),
        live * (63 * (c["fp12_sqr"] + c["dbl_step"] + c["sparse"])
                + 5 * (c["add_step"] + c["sparse"])),
        (n + 1) * (2 * 192 + 2 * 384 + 2 + 2304))
    f = tc.miller_loop_seg((px, py), pinf_t, (qx, qy), qinf_t)

    # K9-K11 at 1 lane (the path's) and 8 lanes, on Miller outputs
    k9 = c["fp12_inv"] + 2 * c["fp12_mul"] + 2 * c["fp12_frob"]
    k10 = 63 * c["fp12_sqr"] + 5 * c["fp12_mul"]
    k11 = {"b": c["fp12_frob"] + c["fp12_mul"],
           "c": 2 * c["fp12_frob"] + 2 * c["fp12_mul"],
           "final": c["fp12_sqr"] + 2 * c["fp12_mul"]}
    for m in (1, 8):
        fm = f[:m].contiguous()
        e = check_kernel(torch, tc.K9, f"K9 easy_exp {m} lanes",
                         lambda: tc.easy_exp(fm), lambda: tc.easy_exp_plain(fm),
                         m * k9, m * 2 * 2304)
        if m == 1:
            out[tc.K9.name] = e
        g = tc.easy_exp_plain(fm)
        for xm1 in (True, False):
            e = check_kernel(
                torch, tc.K10, f"K10 pow_x xm1={xm1} {m} lanes",
                lambda: tc.pow_x(g, xm1), lambda: tc.pow_x_plain(g, xm1),
                m * (k10 + (c["fp12_mul"] if xm1 else 0)), m * 2 * 2304)
            if m == 1 and xm1:
                out[tc.K10.name] = e
        u = tc.pow_x_plain(g, False)
        for mode in tc.COMB_MODES:
            e = check_kernel(
                torch, tc.K11, f"K11 comb {mode} {m} lanes",
                lambda: tc.comb(u, g, mode), lambda: tc.comb_plain(u, g, mode),
                m * k11[mode], m * 3 * 2304)
            if m == 1 and mode == "c":
                out[tc.K11.name] = e

    # the 9-launch chain against the plain chain and the classic path
    f1 = f[:1].contiguous()
    got = tc.final_exp_kernel(f1)
    g = tc.easy_exp_plain(f1)
    a = tc.pow_x_plain(tc.pow_x_plain(g, True), True)
    b = tc.comb_plain(tc.pow_x_plain(a, False), a, "b")
    cc = tc.comb_plain(tc.pow_x_plain(tc.pow_x_plain(b, False), False), b, "c")
    plain = tc.comb_plain(cc, g, "final")
    classic = pairing.final_exponentiation(f1)
    r1, c1, _ = compare(torch, got, plain)
    r2, c2, _ = compare(torch, got, classic)
    if not (c1 and c2):
        raise AssertionError("final_exp_kernel disagrees with the plain chain "
                             "or pairing.final_exponentiation")
    log(f"final_exp_kernel (9 launches): equal after canonical to the plain "
        f"chain ({c1}, raw {r1}) and to pairing.final_exponentiation ({c2}, "
        f"raw {r2})")
    return out


# ----------------------------------------------------- phases 5-6: paths


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


def verify_path(torch, sets, fused: bool, must, must_not) -> dict:
    """The valid and the swapped batch through one path."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.torch_backend import TorchBackend

    be = TorchBackend() if fused else TorchBackend(fused=False)
    if be.fused is not fused:
        raise AssertionError(f"TorchBackend picked fused={be.fused}")
    name = "fused" if fused else "classic"
    S, K = len(sets), len(sets[0].signing_keys)
    ok, valid = run_verify(torch, be, sets, f"{name} valid S={S} K={K}", must, must_not)
    if ok is not True:
        raise AssertionError(f"{name}: the valid batch did not verify")
    bad = swapped(api, sets)
    ok, poisoned = run_verify(torch, be, bad, f"{name} signatures swapped",
                              must, must_not)
    if ok is not False:
        raise AssertionError(f"{name}: the batch with swapped signatures verified")
    log(f"{name} path: {valid['seconds']:.3f} s per batch of {S} sets "
        f"({S / valid['seconds']:.2f} sets/s)")
    return {"valid": valid, "poisoned": poisoned}


def swapped(api, sets):
    bad = list(sets)
    bad[0] = api.SignatureSet(sets[1].signature, sets[0].signing_keys, sets[0].message)
    bad[1] = api.SignatureSet(sets[0].signature, sets[1].signing_keys, sets[1].message)
    return bad


def small_batches(torch, sets, must_by_path) -> None:
    """Both paths on the same two small batches, against the oracle."""
    from lighthouse_tpu_torch.crypto.bls import api
    from lighthouse_tpu_torch.torch_backend import TorchBackend

    small = sets[:2]
    small_bad = [sets[0], swapped(api, sets)[1]]
    for label, batch in (("small", small), ("small tampered", small_bad)):
        want = api.verify_signature_sets_python(batch)
        for fused, (must, must_not) in must_by_path.items():
            be = TorchBackend(fused=fused)
            got, _ = run_verify(
                torch, be, batch,
                f"{'fused' if fused else 'classic'} {label} S=2 "
                f"K={len(batch[0].signing_keys)}", must, must_not)
            if got is not want:
                raise AssertionError(f"{label}: port says {got}, oracle {want}")
    log("small batches: fused and classic paths agree with the pure-Python "
        "oracle (True, False)")


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
    # importing the wrappers registers K1 and the fused kernels
    from lighthouse_tpu_torch.ops import _build, mont_mul, tkernel_calls  # noqa: F401

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}; "
        f"nvidia-smi: {smi}")
    build(torch)

    k1 = check_mont_mul(torch, np, N_VALUES, REPS)

    t0 = time.perf_counter()
    sets, hashes = build_batch(np, N_SETS, N_KEYS, seed=7)
    log(f"batch of S={N_SETS} sets x K={N_KEYS} keys built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    with GpuSampler() as gpu:
        fused = check_fused_kernels(torch, np, sets, hashes)
    clock_mhz = gpu.summary["sm_clock_mhz_max"]
    int_rate = INT_MADS_PER_CLOCK * clock_mhz * 1e6
    log(f"SM clock over the kernel checks: max {clock_mhz} MHz (mean "
        f"{gpu.summary['sm_clock_mhz']}); 32-bit integer multiply-add rate "
        f"132 SMs x 64 x clock = {int_rate:.4g}/s")

    names = [k.name for k in _build.KERNELS]
    fused_names = [n for n in names if n != mont_mul.K1.name]
    must = {True: (names, ()), False: ([mont_mul.K1.name], fused_names)}
    fused_runs = verify_path(torch, sets, True, *must[True])
    classic_runs = verify_path(torch, sets, False, *must[False])
    small_batches(torch, sets, must)
    log(f"per verify of S={N_SETS} x K={N_KEYS}: fused "
        f"{fused_runs['valid']['seconds']:.3f} s, classic "
        f"{classic_runs['valid']['seconds']:.3f} s")

    launches = fused_runs["valid"]["launches"]
    time_at_path_shape(torch, np, k1, fused_runs["valid"]["sizes"][k1["name"]], REPS)
    entries = [k1] + [fused[n] for n in fused_names]
    for e in entries:
        e["launches"] = launches[e["name"]]
        bytes_ms = e.pop("bytes") / HBM_BYTES_PER_S * 1e3
        ops_ms = e.pop("fp_products") * MADS_PER_FP_PRODUCT / int_rate * 1e3
        e["bound_ms"] = max(bytes_ms, ops_ms)
        e["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
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
