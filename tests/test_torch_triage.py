"""Grouped verdicts and poison triage of the port, against the JAX package
(``tests/test_triage.py``'s reference) and the pure-Python oracle.

* Against the JAX package: ``fp12_tree_prod_groups`` on the same seeded
  values, ``triage.py``'s row slicing against ``jax_backend``'s helpers,
  and the triage schedule against ``JaxBackend._triage_device`` with the
  pack and the grouped dispatch stubbed alike on both sides by one fake
  group oracle (no crypto).
* Against the oracle, on the CPU (the plain versions of the kernels): the
  fused core's groups against its MSM form on the same operands, and
  ``verify_signature_sets_triaged`` per set, at the reference's shapes
  (S=4 and S=2, K=2). One dispatch costs ~4 s here on the fused path's
  plain versions and ~6 s on the classic path, so the triage cases run
  fused; a stubbed core covers what needs no pairing (the pack kept and
  sliced, the rejects, the routes).
* Slow tier: both cores' groups against ``jax_backend._verify_grouped_jit``
  on the same limbs and scalars, and ``TorchBackend`` (the CPU's classic
  path) against ``JaxBackend().verify_signature_sets_triaged`` (each
  grouped shape costs XLA:CPU ~2 minutes of compile).
* ``cuda``: the grouped fused core on the card against its plain version.
  The JAX package is imported inside the tests that use it, so

      python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_triage.py

  runs on a GPU machine without JAX.
"""

import importlib

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch import blsrt, torch_backend, triage
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.crypto.bls.curve import g1_infinity, g2_infinity
from lighthouse_tpu_torch.crypto.bls.hash_to_curve import hash_to_g2
from lighthouse_tpu_torch.ops import msm, pairing, points
from lighthouse_tpu_torch.torch_backend import TorchBackend

SKS = [api.SecretKey.from_int(i + 7) for i in range(8)]
M_BAD = b"\xee" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jb():
    return importlib.import_module("lighthouse_tpu.jax_backend")


def _mixed_sets(n=4, bad=(), mod=api, message=None, indexed=False):
    """The reference's batch: n sets alternating one key and an aggregate
    of two; those in ``bad`` signed over another message. ``message``
    gives every set the same one; ``indexed`` gives each key its index
    into the table of the eight keys."""
    sks = [mod.SecretKey.from_int(i + 7) for i in range(8)]
    sets = []
    for i in range(n):
        m = message or bytes([i + 1]) * 32
        signed = M_BAD if i in bad else m
        if i % 2 == 0:
            sk = sks[i % 8]
            sets.append(mod.SignatureSet.single_pubkey(
                sk.sign(signed), sk.public_key(), m, index=i % 8 if indexed else None))
        else:
            a, b = i % 8, (i + 3) % 8
            agg = mod.AggregateSignature.aggregate([sks[a].sign(signed), sks[b].sign(m)])
            sets.append(mod.SignatureSet.multiple_pubkeys(
                agg, [sks[a].public_key(), sks[b].public_key()], m,
                indices=[a, b] if indexed else None))
    return sets


def _oracle(sets):
    return [api.verify_signature_sets_python([s]) for s in sets]


# ----------------------------------------------------------- ops unit


def _fp12(seed, shape):
    """Fp12 values in [0, 2p) per coordinate, as int32 limbs."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape)) * 12
    raw = rng.integers(0, 256, size=(n, 48), dtype=np.uint8)
    ints = [int.from_bytes(r.tobytes(), "little") % (2 * P) for r in raw]
    limbs = np.stack([np.frombuffer(v.to_bytes(48, "little"), np.uint8) for v in ints])
    return limbs.astype(np.int32).reshape(*shape, 2, 3, 2, 48)


def _port_fp12_mul(a, b):
    """The port's fp12_mul on numpy operands (for the reference's code)."""
    from lighthouse_tpu_torch.ops.tower import fp12_mul

    return fp12_mul(torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))).numpy()


@pytest.mark.parametrize("G, n", [(2, 4), (3, 2), (2, 1)])
def test_fp12_tree_prod_groups_matches_reference(monkeypatch, G, n):
    """The reference's fp12_tree_prod_groups, its products taken by the
    port's fp12_mul, gives the port's limbs: the same products in the same
    order (fp12_mul itself is held to the reference's in
    tests/test_torch_ops.py; the reference's own jnp ops below)."""
    from lighthouse_tpu.ops import pairing as jpairing

    monkeypatch.setattr(jpairing, "fp12_mul", _port_fp12_mul)
    f = _fp12(G * 10 + n, (G, n))
    got = pairing.fp12_tree_prod_groups(torch.from_numpy(f), n)
    assert got.shape == (G, 2, 3, 2, 48)
    np.testing.assert_array_equal(got.numpy(), jpairing.fp12_tree_prod_groups(f, n))
    if n == 1:  # group size 1 is the identity
        np.testing.assert_array_equal(got.numpy(), f[:, 0])


def test_fp12_tree_prod_groups_matches_reference_jnp():
    """The same on the reference's own jnp ops, jitted as one program (run
    op by op, its Fp12 product takes ~12 s here; compiled, ~3 s)."""
    import jax

    from lighthouse_tpu.ops.pairing import fp12_tree_prod_groups as ref

    f = _fp12(32, (2, 2))
    got = pairing.fp12_tree_prod_groups(torch.from_numpy(f), 2)
    want = jax.jit(ref, static_argnums=1)(f, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_fp12_tree_prod_groups_rejects_a_size_not_a_power_of_two():
    with pytest.raises(ValueError):
        pairing.fp12_tree_prod_groups(torch.from_numpy(_fp12(1, (1, 3))), 3)


# ------------------------------------------- triage.py against jax_backend


def _pack(cls, n, S, K, seed, table=None, tensor=None):
    """A pack of S rows with seeded contents: grid mode, or table mode
    with ``table`` as (tx, ty); ``tensor`` turns mx into that kind of
    array (a device tensor for the port, a jax.Array for the reference)."""
    rng = np.random.default_rng(seed)
    p = cls(n, S, K)
    if table is None:
        p.px = rng.integers(0, 256, (S, K, 3)).astype(np.int32)
        p.py = rng.integers(0, 256, (S, K, 3)).astype(np.int32)
    else:
        p.tx, p.ty = table
        p.idx = rng.integers(0, 9, (S, K)).astype(np.int32)
    p.pinf = rng.integers(0, 2, (S, K)).astype(bool)
    for f in ("sx", "sy", "mx", "my"):
        setattr(p, f, rng.integers(0, 256, (S, 2, 3)).astype(np.int32))
    p.sinf = rng.integers(0, 2, S).astype(bool)
    p.minf = rng.integers(0, 2, S).astype(bool)
    p.r_bits = rng.integers(0, 2, (S, 64)).astype(np.int32)
    if tensor is not None:
        p.mx = tensor(p.mx)
    return p


FIELDS = ("idx", "px", "py", "pinf", "sx", "sy", "sinf", "mx", "my", "minf", "r_bits")


def _same_pack(mine, ref):
    assert (mine.n, mine.S, mine.K) == (ref.n, ref.S, ref.K)
    for f in FIELDS:
        a, b = getattr(mine, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            a = a.cpu().numpy() if isinstance(a, torch.Tensor) else a
            assert a.dtype == np.asarray(b).dtype, f
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=f)


@pytest.mark.parametrize("sel", [[0, 2, 5], [4], [0, 1, 2, 3, 4, 5]])
def test_slice_pack_matches_reference(sel):
    """A grid pack (6 sets in 8 rows of 2 keys) sliced as the reference
    slices it, the hash rows a tensor on one side and a jax.Array on the
    other; the tensor stays a tensor."""
    import jax.numpy as jnp

    jb = _jb()
    mine = _pack(triage.TriagePack, 6, 8, 2, 3, tensor=torch.from_numpy)
    ref = _pack(jb._TriagePack, 6, 8, 2, 3, tensor=jnp.asarray)
    got = triage.slice_pack(mine, sel)
    assert isinstance(got.mx, torch.Tensor)
    _same_pack(got, jb._slice_packs([(0, ref)], sel))


@pytest.mark.parametrize("sel", [[1, 3], [0, 1, 2]])
def test_slice_pack_table_mode(sel):
    """A table pack keeps the table by reference and slices its index
    grid, as the reference does."""
    jb = _jb()
    tab = (np.zeros((9, 48), np.uint8), np.ones((9, 48), np.uint8))
    got = triage.slice_pack(_pack(triage.TriagePack, 4, 4, 2, 1, table=tab), sel)
    assert got.tx is tab[0] and got.ty is tab[1]
    _same_pack(got, jb._slice_packs([(0, _pack(jb._TriagePack, 4, 4, 2, 1, table=tab))],
                                    sel))


@pytest.mark.parametrize("kind", ["numpy", "tensor"])
@pytest.mark.parametrize("pad", [0, 2])
def test_rows_take_matches_reference(kind, pad):
    jb = _jb()
    a = np.arange(3 * 3 * 2, dtype=np.int32).reshape(3, 3, 2)
    got = triage.rows_take(torch.from_numpy(a) if kind == "tensor" else a, [2, 0], pad, 7)
    assert isinstance(got, torch.Tensor) == (kind == "tensor")
    got = got.numpy() if kind == "tensor" else got
    np.testing.assert_array_equal(got, jb._rows_take(a, [2, 0], pad, 7))


# ------------------------------------- the schedule against the reference


class _FakeSig:
    def is_infinity(self):
        return False


class _FakeSet:
    """A set the stubs know by its id: the fake oracle fails the ids in
    ``bad``; every set has one key and the same message."""

    def __init__(self, i):
        self.id = i
        self.signing_keys = [i]
        self.signature = _FakeSig()
        self.message = b"\x5a" * 32


def _fake_pack(cls, sets):
    """A pack whose r_bits rows carry the set ids (plus one; 0 on padding)."""
    n = len(sets)
    S = 1 << max(0, (n - 1).bit_length())
    pk = cls(n, S, 1)
    ids = np.zeros((S, 1), np.int32)
    ids[:n, 0] = [s.id + 1 for s in sets]
    pk.px = pk.py = np.zeros((S, 1, 1), np.int32)
    pk.pinf = np.zeros((S, 1), bool)
    pk.sx = pk.sy = pk.mx = pk.my = np.zeros((S, 1), np.int32)
    pk.sinf = pk.minf = np.zeros(S, bool)
    pk.r_bits = ids
    return pk


def _group_oracle(pk, n_groups, bad, rounds):
    """A group is poisoned iff it holds a bad id; records (G, gs)."""
    ids = np.asarray(pk.r_bits)[:, 0] - 1
    gs = pk.S // n_groups
    rounds.append((n_groups, gs))
    return np.array([not any(int(i) in bad for i in ids[j * gs:(j + 1) * gs])
                     for j in range(n_groups)])


SCHEDULES = [  # (n, bad, verdict groups)
    (4, (), 2), (4, (2,), 2), (4, (0, 1), 2), (2, (0, 1), 2), (3, (0,), 2),
    (4, (2,), 2),                      # the duplicate-message case
    (8, tuple(range(8)), 2),           # every set bad
    (16, (5,), 2), (13, (0, 12), 2),   # deep refinement, padding rows
    (128, (0, 1, 40, 77, 100, 127), 32), (1024, (317,), 32),
]


@pytest.mark.parametrize("n, bad, vg", SCHEDULES)
def test_triage_schedule_matches_reference(monkeypatch, n, bad, vg):
    """The port's triage over a stubbed pack and dispatch takes the
    reference's rounds, dispatches and (G, gs) per round, with the same
    verdicts and group counts."""
    jb = _jb()
    monkeypatch.setenv("LHTPU_VERDICT_GROUPS", str(vg))
    monkeypatch.setattr(torch_backend, "VERDICT_GROUPS", vg)
    monkeypatch.setenv("LHTPU_PIPELINE", "0")
    monkeypatch.setenv("LHTPU_RESILIENCE", "0")
    sets = [_FakeSet(i) for i in range(n)]
    ref_rounds, my_rounds = [], []

    def ref_dispatch(self, pk, n_groups, stages):
        jb._LAST_TRIAGE["dispatches"] += 1
        return _group_oracle(pk, n_groups, bad, ref_rounds)

    monkeypatch.setattr(jb.JaxBackend, "_pack_for_triage",
                        lambda self, s, stages: _fake_pack(jb._TriagePack, s))
    monkeypatch.setattr(jb.JaxBackend, "_dispatch_grouped", ref_dispatch)
    want = jb.JaxBackend().verify_signature_sets_triaged(sets)
    ref_triage = dict(jb._LAST_TRIAGE)

    def my_dispatch(self, pk, n_groups, stages):
        self.last_triage["dispatches"] += 1
        return torch.from_numpy(_group_oracle(pk, n_groups, bad, my_rounds))

    monkeypatch.setattr(TorchBackend, "_pack_for_triage",
                        lambda self, s, stages: _fake_pack(triage.TriagePack, s))
    monkeypatch.setattr(TorchBackend, "_dispatch_grouped", my_dispatch)
    be = TorchBackend(device="cpu")
    got = be.verify_signature_sets_triaged(sets)
    assert got == want == [i not in bad for i in range(n)]
    assert my_rounds == ref_rounds
    assert be.last_triage == ref_triage


# ----------------------------------------- grouped cores against scalar


def _operands(sets, S, K):
    """The host pack of ``sets`` padded to S rows of K keys: (pk, pk_inf,
    sig, sig_inf, msg, msg_inf) as numpy arrays, padding at infinity."""
    inf1, inf2 = g1_infinity(), g2_infinity()
    px, py, pinf = torch_backend._pack_pubkey_grid(sets, S, K, len(sets), inf1)
    pad = [inf2] * (S - len(sets))
    sx, sy, sinf = points.g2_to_dev([s.signature.point for s in sets] + pad)
    mx, my, minf = points.g2_to_dev([hash_to_g2(s.message) for s in sets] + pad)
    return px, py, pinf, sx, sy, sinf, mx, my, minf


def _core_args(ops, r_bits, rows=slice(None)):
    t = [torch.from_numpy(np.ascontiguousarray(a[rows])) for a in (*ops, r_bits)]
    px, py, pinf, sx, sy, sinf, mx, my, minf, r = t
    return (px, py), pinf, (sx, sy), sinf, (mx, my), minf, r


def test_grouped_core_refines_scalar_core():
    """The reference's batch with set 3 bad through the fused core at
    G = 2 (no MSM): the first group True, the second False; and the clean
    group's verdict equal to that of the MSM form (the main path's) on its
    own rows, the same operands and scalars. The other bad patterns run
    through the triage below."""
    ops = _operands(_mixed_sets(4, (3,)), 4, 2)
    r_u64, r_bits = torch_backend._rand_scalars(4)
    got = torch_backend._verify_core_fused(*_core_args(ops, r_bits), n_groups=2)
    assert got.dtype == torch.bool and got.tolist() == [True, False]
    sched = msm.build_schedule(r_u64[:2], msm.max_rounds(2), np.zeros(2, bool))
    whole = torch_backend._verify_core_fused(*_core_args(ops, r_bits, slice(0, 2)),
                                             *(torch.from_numpy(a) for a in sched))
    assert whole.shape == (1,) and bool(whole) is bool(got[0]) is True


def test_msm_core_takes_one_group():
    """The MSM yields one accumulator: a grouped call with a schedule is
    refused before any work, as is a group count that does not divide S."""
    ops = (None, torch.zeros(4, 2, dtype=torch.bool)) + (None,) * 5
    with pytest.raises(ValueError, match="one accumulator"):
        torch_backend._verify_core_fused(*ops, torch.zeros(1), torch.zeros(1), n_groups=2)
    with pytest.raises(ValueError, match="do not divide"):
        torch_backend._verify_core(*ops, n_groups=3)


@pytest.mark.parametrize("G", [1, 2])
def test_pair_operands_add_one_check_pair_per_group(G):
    """S set lanes, then G check lanes of -g1 against each group's
    accumulator (G = 1: the S + 1 lanes of a batch verify)."""
    from lighthouse_tpu_torch.ops import field
    from lighthouse_tpu_torch.ops.points import G1_GEN_DEV

    S = 2
    rpk = (torch.zeros(S, 48, dtype=torch.int32), torch.ones(S, 48, dtype=torch.int32),
           torch.zeros(S, dtype=torch.bool))
    acc = (torch.arange(G * 96, dtype=torch.int32).reshape(G, 2, 48),
           torch.full((G, 2, 48), 4, dtype=torch.int32), torch.arange(G) == 0)
    msg = (torch.full((S, 2, 48), 5, dtype=torch.int32),) * 2
    out = torch_backend._pair_operands(rpk, acc, msg, torch.zeros(S, dtype=torch.bool))
    L = S + G
    assert [tuple(t.shape) for t in out] == [(L, 48), (L, 48), (L,), (L, 2, 48),
                                             (L, 2, 48), (L,)]
    for lane in range(S, L):
        np.testing.assert_array_equal(out[0][lane].numpy(), G1_GEN_DEV[0])
        np.testing.assert_array_equal(out[1][lane].numpy(),
                                      field.neg(torch.from_numpy(G1_GEN_DEV[1])).numpy())
    assert torch.equal(out[3][S:], acc[0]) and torch.equal(out[4][S:], acc[1])
    assert out[2].tolist() == [False] * L
    assert out[5].tolist() == [False] * S + acc[2].tolist()


# --------------------------------------- verify_signature_sets_triaged


@pytest.mark.parametrize("n, bad, max_dispatches", [
    (4, (), 1),          # clean: one grouped dispatch
    (4, (2,), 2),        # one poisoned group -> one refinement at gs=1
    (4, (0, 1), 2),      # a whole group bad
    (2, (0, 1), 1),      # gs=1 in round 1: exact verdicts
    (3, (0,), 2),        # n not a power of two: the padding row's group
])
def test_triage_matches_python_oracle(monkeypatch, n, bad, max_dispatches):
    """Per-set verdicts equal to the oracle's at G = 2 (the reference's
    shapes) on the fused path's plain versions, with one pack and one hash
    whatever the rounds."""
    calls = []
    for name in ("_pack_pubkey_grid", "_rand_scalars"):
        fn = getattr(torch_backend, name)
        monkeypatch.setattr(torch_backend, name,
                            lambda *a, fn=fn, name=name, **k: calls.append(name) or fn(*a, **k))
    monkeypatch.setattr(torch_backend, "VERDICT_GROUPS", 2)
    sets = _mixed_sets(n, bad)
    be = TorchBackend(device="cpu", fused=True)
    got = be.verify_signature_sets_triaged(sets)
    assert got == _oracle(sets) == [i not in bad for i in range(n)]
    tr = be.last_triage
    assert tr["enabled"] and tr["fallback"] is None and tr["sets"] == n
    assert tr["dispatches"] == tr["rounds"] <= max_dispatches
    assert be.last_path == "fused+triage"
    assert sorted(calls) == ["_pack_pubkey_grid", "_rand_scalars"]
    assert be.last_stage_seconds.calls["pack"] == 1
    assert be.last_stage_seconds.calls["hash_to_curve"] == 1
    assert be.last_stage_seconds.calls["dispatch"] == tr["dispatches"]


def test_triage_indexed_poisoned_duplicate_message():
    """All four sets sign one message and set 2 another, their keys given
    by validator index into the registered table: the pubkeys gather from
    the table ("indexed+triage"), the hash batch dedups to one row, and
    the verdicts must not alias (the default verdict groups: one dispatch
    at group size 1)."""
    table = blsrt.DevicePubkeyTable()
    table.append_pubkeys([sk.public_key() for sk in SKS])
    sets = _mixed_sets(4, (2,), message=b"\x5a" * 32, indexed=True)
    blsrt.set_device_table(table)
    try:
        be = TorchBackend(device="cpu", fused=True)
        got = be.verify_signature_sets_triaged(sets)
    finally:
        blsrt.set_device_table(None)
    assert got == [True, True, False, True] == _oracle(sets)
    assert be.last_path == "indexed+triage" and be.last_triage["dispatches"] == 1


class _RowOracle:
    """A stand-in grouped core (no pairing): a row is bad iff its signature
    limbs are one of ``bad_sigs``; records the operands of each call."""

    def __init__(self, bad_sigs):
        self.bad = points.g2_to_dev([s.point for s in bad_sigs])[0] if bad_sigs else None
        self.calls = []

    def __call__(self, pk, pk_inf, sig, sig_inf, msg, msg_inf, r_bits, n_groups):
        self.calls.append({"sig": sig[0].clone(), "sig_inf": sig_inf.clone(),
                           "msg": msg[0].clone(), "r_bits": r_bits.clone(),
                           "n_groups": n_groups})
        S = sig_inf.shape[0]
        bad = torch.zeros(S, dtype=torch.bool)
        if self.bad is not None:
            for row in torch.from_numpy(self.bad):
                bad |= (sig[0] == row).flatten(1).all(1) & ~sig_inf
        return ~bad.reshape(n_groups, S // n_groups).any(1)


def test_refinement_repacks_nothing(monkeypatch):
    """Three rounds from one pack (7 sets, set 5 bad, G = 2): each
    refinement's operands are the round-1 rows of its suspects
    (signatures, hashed messages, the RLC scalars never redrawn), padded
    with inert rows; pack, hash and scalars ran once."""
    calls = []
    for name in ("_pack_pubkey_grid", "_rand_scalars"):
        fn = getattr(torch_backend, name)
        monkeypatch.setattr(torch_backend, name,
                            lambda *a, fn=fn, name=name, **k: calls.append(name) or fn(*a, **k))
    monkeypatch.setattr(torch_backend, "VERDICT_GROUPS", 2)
    sets = _mixed_sets(7, (5,))
    be = TorchBackend(device="cpu", fused=True)
    core = _RowOracle([sets[5].signature])
    be._core = core
    assert be.verify_signature_sets_triaged(sets) == [i != 5 for i in range(7)]
    assert sorted(calls) == ["_pack_pubkey_grid", "_rand_scalars"]
    assert be.last_stage_seconds.calls["hash_to_curve"] == 1
    assert [c["n_groups"] for c in core.calls] == [2, 2, 2]
    assert [c["sig"].shape[0] for c in core.calls] == [8, 4, 2]
    r1, r2, r3 = core.calls
    for key in ("sig", "msg", "r_bits"):
        assert torch.equal(r2[key][:3], r1[key][4:7]), key   # sets 4, 5, 6
        assert torch.equal(r3[key], r1[key][4:6]), key       # sets 4, 5
    assert r2["sig_inf"].tolist() == [False, False, False, True]
    assert not r2["r_bits"][3].any()
    assert be.last_triage["rounds"] == be.last_triage["dispatches"] == 3


def test_triage_structural_rejects_skip_device():
    """Sets with no keys or an infinity signature are False and never
    packed; a batch of nothing else never dispatches."""
    good = _mixed_sets(2)
    inf = api.SignatureSet.multiple_pubkeys(api.AggregateSignature(), [SKS[0].public_key()],
                                            b"\x01" * 32)
    empty = api.SignatureSet.multiple_pubkeys(good[0].signature, [], b"\x01" * 32)
    be = TorchBackend(device="cpu", fused=True)
    core = _RowOracle([])
    be._core = core
    assert be.verify_signature_sets_triaged([inf, empty]) == [False, False]
    assert core.calls == [] and be.last_triage["dispatches"] == 0
    assert be.last_triage["structural_rejects"] == 2
    assert be.verify_signature_sets_triaged([good[0], inf, good[1]]) == [True, False, True]
    assert len(core.calls) == 1 and core.calls[0]["sig"].shape[0] == 2
    assert be.last_triage["structural_rejects"] == 1
    assert be.verify_signature_sets_triaged([]) == []


# ----------------------------------------------------- the api's bisection


class _Fake:
    def __init__(self, ok):
        self.ok = ok


def _patch_counting_verify(monkeypatch):
    calls = []

    def fake(sets, device=None):
        calls.append(len(sets))
        return all(s.ok for s in sets)

    monkeypatch.setattr(api, "verify_signature_sets", fake)
    return calls


def test_bisect_all_good_is_one_call(monkeypatch):
    calls = _patch_counting_verify(monkeypatch)
    assert api.bisect_verify_sets([_Fake(True)] * 8) == [True] * 8
    assert calls == [8]


def test_bisect_single_bad_is_logarithmic(monkeypatch):
    calls = _patch_counting_verify(monkeypatch)
    sets = [_Fake(i != 5) for i in range(8)]
    assert api.bisect_verify_sets(sets) == [i != 5 for i in range(8)]
    assert calls[0] == 8 and len(calls) <= 2 * (8).bit_length() + 3
    calls.clear()
    assert api.bisect_verify_sets([_Fake(False)]) == [False]
    assert calls == [1]


def test_bisect_budget_exhaustion_goes_linear(monkeypatch):
    calls = _patch_counting_verify(monkeypatch)
    got = api.bisect_verify_sets([_Fake(False) for _ in range(8)], budget=[1])
    assert got == [False] * 8
    assert calls[0] == 8 and set(calls[1:]) == {1} and len(calls) == 9


def test_triaged_api_routes_to_the_backend(monkeypatch):
    seen = []

    def routed(self, sets):
        seen.append(self.device)
        return ["routed"] * len(sets)

    monkeypatch.setattr(TorchBackend, "verify_signature_sets_triaged", routed)
    assert api.verify_signature_sets_triaged([1, 2], device="cpu") == ["routed"] * 2
    assert seen == [torch.device("cpu")]


# --------------------------------------------------------------- slow tier


@pytest.mark.slow
def test_grouped_cores_match_reference_grouped_jit():
    """The classic and fused cores at two groups against the reference's
    ``_verify_grouped_jit`` on the same limbs and RLC bits (S=4, G=2)."""
    jb = _jb()
    sets = _mixed_sets(4, (1,))
    ops = _operands(sets, 4, 2)
    r_bits = torch_backend._rand_scalars(4)[1]
    px, py, pinf, sx, sy, sinf, mx, my, minf = ops
    want = np.asarray(jb._verify_grouped_jit(
        (px, py), pinf, (sx, sy), sinf, (mx, my), minf, r_bits, n_groups=2))
    assert want.tolist() == [False, True]
    for core in (torch_backend._verify_core, torch_backend._verify_core_fused):
        assert core(*_core_args(ops, r_bits), n_groups=2).tolist() == want.tolist()


@pytest.mark.slow
@pytest.mark.parametrize("n, bad", [(4, (2,)), (3, (0,))])
def test_triage_matches_jax_backend(monkeypatch, n, bad):
    """TorchBackend(device="cpu") (the classic path) against JaxBackend's
    triage on the same sets at verdict groups 2: the same verdicts,
    dispatches and rounds."""
    from lighthouse_tpu.common import resilience
    from lighthouse_tpu.crypto.bls import api as japi

    jb = _jb()
    monkeypatch.setenv("LHTPU_VERDICT_GROUPS", "2")
    monkeypatch.setattr(torch_backend, "VERDICT_GROUPS", 2)
    monkeypatch.setenv("LHTPU_PIPELINE", "0")
    monkeypatch.setenv("LHTPU_RETRY_BASE_MS", "0")
    resilience.reset()
    want = jb.JaxBackend().verify_signature_sets_triaged(_mixed_sets(n, bad, mod=japi))
    ref = dict(jb._LAST_TRIAGE)
    resilience.reset()
    be = TorchBackend(device="cpu")
    assert be.verify_signature_sets_triaged(_mixed_sets(n, bad)) == want
    assert be.last_path == "classic+triage"
    assert ref["fallback"] is None
    assert (be.last_triage["dispatches"], be.last_triage["rounds"]) == (
        ref["dispatches"], ref["rounds"])


# -------------------------------------------------------------------- card


@pytest.mark.cuda
def test_fused_grouped_core_on_the_card():
    """The grouped fused core's kernels at S=8, G=4 against its plain
    version on the same operands: the same verdicts, one bad group."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    sets = _mixed_sets(8, (5,))
    ops = _operands(sets, 8, 2)
    r_bits = torch_backend._rand_scalars(8)[1]
    plain = torch_backend._verify_core_fused(*_core_args(ops, r_bits), n_groups=4)
    args = _core_args(ops, r_bits)
    cuda = tuple(tuple(t.cuda() for t in a) if isinstance(a, tuple) else a.cuda()
                 for a in args)
    got = torch_backend._verify_core_fused(*cuda, n_groups=4)
    assert got.device.type == "cuda"
    assert got.cpu().tolist() == plain.tolist() == [True, True, False, True]
