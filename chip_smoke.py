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
4. each fused verify kernel (K2-K4, K8-K11) and the full-order subgroup
   check K15 against its plain version on the card, at the shapes the fused
   path gives it and with its edge lanes (infinity, Z = 1, scalars 0, 1 and
   2^64-1, points outside G2): equality after ``canonical`` (and whether
   the raw limbs match), K4 also against K15, the final-exponentiation
   chain also against the classic ``pairing.final_exponentiation``; kernel
   and plain times;
5. the MSM kernels (K5 accumulate, K6 tree, K7 Horner) against their plain
   versions at the main path's shapes (the batch's 128 signatures, a
   schedule from seeded scalars, L = 48), on all 256 lanes (K7 on lane 0),
   then on the edge batch (a duplicate signature whose mixed addition
   doubles, S and -S cancelling in a bucket before a further addition, an
   empty bucket) and with every set skipped; the MSM point against the scan
   (K3 G2 and the S-leaf tree) and the oracle's sum r_i S_i at canonical
   affine; kernel-only times of the MSM against the scan at S=2048;
6. the hash kernels (K12 resident map, K13 SSWU + isogeny, K14 cofactor)
   against their plain versions at the shapes the batch's 128 distinct
   messages give them and on edge lanes (u = 0 on both halves, u0 == u1,
   a lane at infinity, the RFC 9380 J.10.1 messages), both SSWU branches
   among the lanes; K12 + K2 against the RFC vectors; the device hash,
   resident and chained, against the oracle's points of all 128 messages;
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
10. the ``kernels`` JSON line, the nvidia-smi line, and the result line.

Kernel launch counts are zeroed just before each verify and read just after
it. Each configuration has its list: the default fused path must launch K1,
K2, K3 G1, K4, K5-K7 (once each), K8-K12 and not K3 G2, K13, K14 or K15;
with ``msm=False`` K3 G2 and not K5-K7; with the chained hash K13 and K14
and not K12; with the host hash none of K12-K14; the classic path K1 and
none of the others. No verify launches K15: its launches are those of the
K4-against-K15 check.

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


def subgroup_full_products(c: dict, P: int) -> int:
    """K15's Fp products for one finite lane: a doubling per bit of the
    curve order below its top, a complete addition on each one bit."""
    from lighthouse_tpu_torch.crypto.bls.constants import R

    return (R.bit_length() - 1) * c["dbl_g2"] + (bin(R).count("1") - 1) * c["add_g2"]


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
    # K15, the full-order check [r]Q == inf, on the same lanes: 254
    # doublings and an addition on each of r's 133 one bits below its top
    out[tc.K15.name] = check_kernel(
        torch, tc.K15, f"K15 subgroup_full {n} lanes",
        lambda: tc.subgroup_check_g2(sx, sy, sinf_t),
        lambda: points.pt_subgroup_check(
            FP2_OPS, points.pt_from_affine(FP2_OPS, sx, sy, sinf_t)),
        int((~sinf).sum()) * subgroup_full_products(c, P), n * (2 * 384 + 2))
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


def check_msm_kernels(torch, np, sets) -> dict:
    """K5, K6 and K7 against their plain versions on the card at the main
    path's shapes (the batch's 128 signatures, seeded scalars, L = 48), on
    every lane after canonical (K7 on its one lane); then on the edge batch
    and with every set skipped; the MSM point against the scan (K3 G2, the
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
    out[msm.K5.name] = check_kernel(
        torch, msm.K5, f"K5 msm_accum {n} sets, L={L}, 256 lanes",
        lambda: msm.accumulate(sx, sy, ti, tv),
        lambda: msm.accum_plain(sx, sy, ti, tv),
        work["msm_accum"], n * 2 * 384 + L * 240 * 5 + 3 * 256 * 384)
    B = msm.accum_plain(sx, sy, ti, tv)
    out[msm.K6.name] = check_kernel(
        torch, msm.K6, "K6 msm_tree 256 lanes",
        lambda: msm.tree(B), lambda: msm.tree_plain(B),
        work["msm_tree"], 2 * 3 * 256 * 384)
    T = msm.tree_plain(B)
    out[msm.K7.name] = check_kernel(
        torch, msm.K7, "K7 msm_horner lane 0",
        lambda: msm.horner(T), lambda: msm.horner_plain(T),
        work["msm_horner"], 16 * 3 * 384 + 3 * 384)
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
        check_kernel(torch, msm.K5, f"K5 {label}", lambda: msm.accumulate(ex, ey, ei, ev),
                     lambda: msm.accum_plain(ex, ey, ei, ev), 0, 0, time_it=False)
        EB = msm.accum_plain(ex, ey, ei, ev)
        check_kernel(torch, msm.K6, f"K6 {label}", lambda: msm.tree(EB),
                     lambda: msm.tree_plain(EB), 0, 0, time_it=False)
        ET = msm.tree_plain(EB)
        check_kernel(torch, msm.K7, f"K7 {label}", lambda: msm.horner(ET),
                     lambda: msm.horner_plain(ET), 0, 0, time_it=False)
        ax, ay, ainf = tc.to_affine_g2(tuple(t[None] for t in msm.msm_g2(ex, ey, ei, ev)))
        if skip is not None:
            (pt,) = points.g2_from_dev(ax, ay, ainf)
            if pt != oracle_msm(pts, re, skip):
                raise AssertionError(f"MSM ({label}) != the oracle's sum r_i S_i")
            log(f"MSM ({label}) equals the oracle's sum r_i S_i")
    if not bool(ainf[0]):
        raise AssertionError("MSM with every set skipped is not infinity")
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
    B = msm.accumulate(sx, sy, ti, tv)
    res = {
        "S": n, "L": L, "bucket_max": int(valid.sum(0).max()),
        "msm_ms": median_ms(torch, run_msm, KERNEL_REPS, warmup=1),
        "k5_ms": median_ms(torch, lambda: msm.accumulate(sx, sy, ti, tv), KERNEL_REPS, warmup=1),
        "k6_ms": median_ms(torch, lambda: msm.tree(B), KERNEL_REPS, warmup=1),
        "k7_ms": median_ms(torch, lambda: msm.horner(B), KERNEL_REPS, warmup=1),
        "scan_ms": median_ms(torch, run_scan, KERNEL_REPS, warmup=1),
        "k3_g2_ms": median_ms(torch, lambda: tc.scalar_mul_g2(sx, sy, none, bits),
                              KERNEL_REPS, warmup=1),
    }
    log(f"MSM vs scan at S={n} (kernel-only, CUDA events, median of "
        f"{KERNEL_REPS}), equal at canonical affine: {json.dumps(res)}")
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

    out[th.K12.name] = check_kernel(
        torch, th.K12, f"K12 map_to_g2 {n} lanes",
        lambda: th.map_to_g2_resident(us), lambda: th.map_to_g2_resident_plain(us),
        k13_products + n * (c["add_g2"] + c["cofactor"]), n * (768 + 3 * 384))
    flat = torch.cat([us[:, 0], us[:, 1]])
    out[th.K13.name] = check_kernel(
        torch, th.K13, f"K13 sswu_iso {2 * n} lanes",
        lambda: th.sswu_iso(flat), lambda: th.sswu_iso_plain(flat),
        k13_products, 2 * n * (384 + 3 * 384))
    J = th.sswu_iso_plain(flat)
    Q = points.pt_add(points.FP2_OPS, tuple(t[:n] for t in J), tuple(t[n:] for t in J))
    out[th.K14.name] = check_kernel(
        torch, th.K14, f"K14 cofactor {n} lanes",
        lambda: th.clear_cofactor(Q), lambda: th.cofactor_plain(Q),
        n * c["cofactor"], n * 2 * 3 * 384)

    # edge lanes: each kernel against its plain version, not timed
    edge = hash_edge_inputs(torch, np, msgs)
    m = edge.shape[0]
    check_kernel(torch, th.K12, f"K12 map_to_g2 {m} edge lanes",
                 lambda: th.map_to_g2_resident(edge),
                 lambda: th.map_to_g2_resident_plain(edge), 0, 0, time_it=False)
    eflat = torch.cat([edge[:, 0], edge[:, 1]])
    check_kernel(torch, th.K13, f"K13 sswu_iso {2 * m} edge lanes",
                 lambda: th.sswu_iso(eflat), lambda: th.sswu_iso_plain(eflat),
                 0, 0, time_it=False)
    EJ = th.sswu_iso_plain(eflat)
    EQ = tuple(t.clone() for t in points.pt_add(
        points.FP2_OPS, tuple(t[:m] for t in EJ), tuple(t[m:] for t in EJ)))
    EQ[2][2] = 0  # a lane at infinity
    check_kernel(torch, th.K14, f"K14 cofactor {m} edge lanes",
                 lambda: th.clear_cofactor(EQ), lambda: th.cofactor_plain(EQ),
                 0, 0, time_it=False)

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
    build(torch)

    k1 = check_mont_mul(torch, np, N_VALUES, REPS)

    t0 = time.perf_counter()
    sets, hashes = build_batch(np, N_SETS, N_KEYS, seed=7)
    log(f"batch of S={N_SETS} sets x K={N_KEYS} keys built on the host in "
        f"{time.perf_counter() - t0:.1f} s")

    with GpuSampler() as gpu:
        fused = check_fused_kernels(torch, np, sets, hashes)
        fused.update(check_msm_kernels(torch, np, sets))
        wide = msm_against_scan(torch, np, sets, 2048)
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
        ops_ms = e.pop("fp_products") * MADS_PER_FP_PRODUCT / int_rate * 1e3
        e["bound_ms"] = max(bytes_ms, ops_ms)
        e["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"MSM against the scan at S={wide['S']}: MSM {wide['msm_ms']:.4f} ms "
        f"(K5 {wide['k5_ms']:.4f}, K6 {wide['k6_ms']:.4f}, K7 {wide['k7_ms']:.4f}), "
        f"scan {wide['scan_ms']:.4f} ms (K3 G2 {wide['k3_g2_ms']:.4f})")
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
