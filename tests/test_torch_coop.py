"""The straight-line Fp programs of kernels K8 and K10 (``ops/coop.py``) on
the CPU.

Each program, run by ``run_program`` over the port's ``ops/field.py``
operations, must give the limbs of the plain version it transcribes
exactly (raw int32 limbs, no reduction), on seeded random inputs in
[0, 2p) at 2-3 lanes: ``tower.fp12_sqr`` and ``fp12_mul``, the Miller
doubling and addition bits (``pairing._dbl_step`` / ``_add_step`` with
``tkernel_pairing._mul_line_sparse``), and the kernels' whole schedules
against ``tkernel_calls.pow_x_plain`` and ``miller_loop_seg``. Every round
must read no slot it writes and write no slot twice; the round counts are
those PERF.md states. The kernels themselves run on the card
(``tests/test_torch_kernels.py``).
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.curve import g1_generator, g2_generator
from lighthouse_tpu_torch.ops import coop, pairing, points, tower
from lighthouse_tpu_torch.ops import tkernel_calls as tc
from lighthouse_tpu_torch.ops.tkernel_pairing import _mul_line_sparse, miller_loop_seg

CSRC = Path(__file__).resolve().parent.parent / "lighthouse_tpu_torch" / "csrc"
PROGRAMS = {p.name: p for p in coop.pow_x_programs() + coop.miller_programs()}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _fp(seed, *shape):
    """Random Fp limbs in [0, 2p), int32 [*shape, 48]."""
    a = np.random.default_rng(seed).integers(0, 256, size=(*shape, 48), dtype=np.int32)
    a[..., 47] %= 0x34  # 2p's top byte is 0x34
    return torch.from_numpy(a)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _run(program, *fixed):
    """Run ``program`` on fixed slots filled from ``fixed`` (each [n, k, 48]
    in slot order); returns the slots."""
    fixed = torch.cat([f.reshape(f.shape[0], -1, 48) for f in fixed], 1)
    slots = torch.zeros(fixed.shape[0], program.n_slots, 48, dtype=torch.int32)
    slots[:, :fixed.shape[1]] = fixed
    coop.run_program(program, slots)
    return slots


# ---------------------------------------------------------------- rounds

# (product rounds, add rounds, Fp products) per program (PERF.md section 6)
ROUNDS = {
    "fp12_sqr": (1, 12, 36),
    "fp12_mul": (1, 11, 54),
    "conj_mul": (1, 12, 54),
    "miller_dbl": (4, 32, 106),
    "miller_add": (5, 27, 80),
}


@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_program_rounds(name):
    p = PROGRAMS[name]
    coop.check_rounds(p)
    assert (p.product_rounds, p.add_rounds, p.products) == ROUNDS[name]
    # the widest round fits the block's threads in one pass
    assert max(len(r) for r in p.rounds) <= coop.THREADS


def test_rounds_per_lane():
    """K10 at x: 63 squarings and 5 products; xm1 adds the conj product.
    K8: 63 doubling bits and 5 addition bits."""
    assert coop.rounds_per_lane(coop.pow_x_plan(False)) == (68, 811, 2538)
    assert coop.rounds_per_lane(coop.pow_x_plan(True)) == (69, 823, 2592)
    assert coop.rounds_per_lane(coop.miller_plan()) == (277, 2151, 7078)


def test_check_rounds_rejects_a_hazard():
    p = PROGRAMS["fp12_mul"]
    last = p.rounds[-1].copy()
    last[0, 2] = last[1, 1]  # op 0 reads what op 1 writes
    with pytest.raises(AssertionError, match="read and written"):
        coop.check_rounds(coop.Program(p.name, p.rounds[:-1] + (last,), p.n_slots))
    last = p.rounds[-1].copy()
    last[0, 1] = last[1, 1]
    with pytest.raises(AssertionError, match="written twice"):
        coop.check_rounds(coop.Program(p.name, p.rounds[:-1] + (last,), p.n_slots))


# ---------------------------------------------------- programs vs plain


def test_pow_programs_match_tower():
    a, b = _fp(1, 3, 2, 3, 2), _fp(2, 3, 2, 3, 2)
    want = {
        "fp12_sqr": tower.fp12_sqr(a),
        "fp12_mul": tower.fp12_mul(a, b),
        "conj_mul": tower.fp12_mul(tower.fp12_conj(a), tower.fp12_conj(b)),
    }
    for name, w in want.items():
        got = _run(PROGRAMS[name], a, b)[:, coop.POW_ACC:coop.POW_ACC + 12]
        assert torch.equal(got.reshape(w.shape), w), name


def test_miller_programs_match_steps():
    f = _fp(3, 3, 2, 3, 2)
    T = (_fp(4, 3, 2), _fp(5, 3, 2), _fp(6, 3, 2))
    xp, yp, xq, yq = _fp(7, 3, 1), _fp(8, 3, 1), _fp(9, 3, 2), _fp(10, 3, 2)
    fixed = (f, *T, xp, yp, xq, yq)
    T2, line = pairing._dbl_step(T)
    want_dbl = _mul_line_sparse(tower.fp12_sqr(f), line, xp[:, 0], yp[:, 0]), T2
    T2, line = pairing._add_step(T, (xq, yq))
    want_add = _mul_line_sparse(f, line, xp[:, 0], yp[:, 0]), T2
    for name, (wf, wT) in (("miller_dbl", want_dbl), ("miller_add", want_add)):
        slots = _run(PROGRAMS[name], *fixed)
        assert torch.equal(slots[:, coop.MIL_F:coop.MIL_F + 12].reshape(wf.shape), wf)
        got_T = slots[:, coop.MIL_T:coop.MIL_T + 6].reshape(3, 3, 2, 48)
        assert all(torch.equal(got_T[:, i], wT[i]) for i in range(3)), name


def test_pow_x_schedule_matches_plain():
    f = _fp(11, 2, 2, 3, 2)
    for xm1 in (False, True):
        assert torch.equal(coop.pow_x_steps(f, xm1), tc.pow_x_plain(f, xm1)), xm1


def test_miller_schedule_matches_plain():
    """Two lanes, P at infinity on the second."""
    px, py, pinf = map(_t, points.g1_to_dev(
        [g1_generator().mul(k) for k in (3, 4)]))
    qx, qy, qinf = map(_t, points.g2_to_dev(
        [g2_generator().mul(k) for k in (6, 7)]))
    pinf[1] = True
    got = coop.miller_steps((px, py), pinf, (qx, qy), qinf)
    assert torch.equal(got, miller_loop_seg((px, py), pinf, (qx, qy), qinf))


# ------------------------------------------------------------- packing


def test_pack_layout_round_trips():
    """The int16 layout csrc/coop.cuh reads gives back the plan: loads,
    stores, steps and every round."""
    plan = coop.miller_plan()
    progs = plan.programs
    buf = coop.pack(plan).astype(np.int64)
    n_slots, n_progs, n_loads, n_stores, n_steps = buf[:coop.HEADER]
    assert (n_slots, n_progs) == (max(p.n_slots for p in progs), len(progs))
    table = buf[coop.HEADER + n_progs:]
    assert np.array_equal(table[:4 * n_loads].reshape(-1, 4), plan.loads)
    table = table[4 * n_loads:]
    assert np.array_equal(table[:2 * n_stores].reshape(-1, 2), plan.stores)
    assert np.array_equal(table[2 * n_stores:2 * n_stores + n_steps], plan.steps)
    for k, p in enumerate(progs):
        q = buf[buf[coop.HEADER + k]:]
        n_rounds = q[0]
        ops = q[2 + n_rounds:]
        assert n_rounds == len(p.rounds)
        for r, want in enumerate(p.rounds):
            got = ops[4 * q[1 + r]:4 * q[2 + r]].reshape(-1, 4)
            assert np.array_equal(got, want)
    dev = coop.to_device(plan, "cpu")
    assert dev.dtype == torch.int16 and dev is coop.to_device(plan, "cpu")
    for pl in (plan, coop.pow_x_plan(False), coop.pow_x_plan(True)):
        b = coop.pack(pl)
        assert coop.shared_bytes(pl) == \
            b[0] * 48 + (2 * len(b) + 15) // 16 * 16 <= 48 * 1024


# ------------------------------------------------ constants in the sources


def _const(text, name):
    return int(re.search(rf"\b{name} = (-?\d+)", text).group(1))


@pytest.mark.parametrize("source, names", [
    ("coop.cuh", {"kMul": coop.MUL, "kAdd": coop.ADD, "kSub": coop.SUB,
                  "kNeg": coop.NEG}),
    ("coop.cuh", {"kLoadZero": coop.ZERO, "kLoadOne": coop.ONE}),
    ("coop.cuh", {"kHeader": coop.HEADER}),
    ("lanes.cuh", {"kCoopThreads": coop.THREADS}),
])
def test_kernel_constants_match_python(source, names):
    text = (CSRC / source).read_text()
    assert {name: _const(text, name) for name in names} == names
