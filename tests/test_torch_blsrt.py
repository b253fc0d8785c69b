"""The port's input path (``lighthouse_tpu_torch/blsrt.py`` and the cached
pack of ``torch_backend``) against the JAX package's ``blsrt`` and
``JaxBackend._pack_pubkey_grid`` on the same inputs.

Everything compared here is numpy on both sides (the JAX package's caches,
pack and table bookkeeping trace no JAX program), so these run in the fast
tier; the table builds run the port's plain versions on the CPU. The one
live comparison with the JAX package's device-built table is slow.
"""

import itertools

import numpy as np
import pytest
import torch

from lighthouse_tpu import blsrt as jblsrt
from lighthouse_tpu.crypto.bls.api import PublicKey, SecretKey, SignatureSet
from lighthouse_tpu.crypto.bls.curve import g1_generator, g1_infinity, g2_infinity
from lighthouse_tpu.jax_backend import JaxBackend
from lighthouse_tpu.ops.points import g1_to_dev
from lighthouse_tpu_torch import blsrt, interop, torch_backend
from lighthouse_tpu_torch.torch_backend import TorchBackend

_names = itertools.count()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fresh_caches():
    """Both packages' module caches empty before and after the test."""
    jblsrt.reset_input_caches()
    blsrt.reset_input_caches()
    yield
    jblsrt.reset_input_caches()
    blsrt.reset_input_caches()


def _keys(n, base=11, raw=True):
    """n distinct pubkeys (base + i) G; with ``raw`` they carry their
    serialized bytes, as keys read off the wire do."""
    g = g1_generator()
    pt = g.mul(base)
    out = []
    for _ in range(n):
        pk = PublicKey(pt)
        out.append(PublicKey(pt, pk.to_bytes()) if raw else pk)
        pt = pt.add(g)
    return out


def _sets(key_rows):
    sig = SecretKey.from_int(5).sign(b"\x01" * 32)
    return [SignatureSet.multiple_pubkeys(sig, row, bytes([i]) * 32)
            for i, row in enumerate(key_rows)]


def _shape(sets):
    n = len(sets)
    S = torch_backend.next_pow2(n)
    K = torch_backend.next_pow2(max(len(s.signing_keys) for s in sets))
    return S, K, n


def _jax_events(name):
    out = {"hit": 0, "miss": 0, "evict": 0, "bypass": 0}
    for labels, v in jblsrt.CACHE_EVENTS.items():
        if labels["cache"] == name:
            out[labels["event"]] = int(v)
    return out


def test_row_cache_matches_jax_slot_for_slot():
    """The same key sequence through both arenas: the same slots, misses
    and evictions, and rows gathered back byte for byte."""
    name = f"t_rows_{next(_names)}"
    mine = blsrt.PubkeyRowCache(name, 4)
    ref = jblsrt.PubkeyRowCache(name, "LHTPU_TORCH_TEST_ROWS_UNSET", 4)
    rng = np.random.default_rng(15)
    for step in range(12):
        keys = [bytes([int(k)]) for k in rng.integers(0, 7, size=3)]
        idx_m, miss_m = mine.lookup(keys)
        idx_r, miss_r = ref.lookup(keys)
        assert miss_m == miss_r and np.array_equal(idx_m, idx_r), step
        for i in miss_m:
            row = rng.integers(0, 256, size=(2, 48), dtype=np.int32)
            sm = mine.insert(keys[i], row[0], row[1], bool(step % 2))
            sr = ref.insert(keys[i], row[0], row[1], bool(step % 2))
            assert sm == sr
            idx_m[i] = idx_r[i] = sm
        for a, b in zip(mine.gather(idx_m), ref.gather(idx_r)):
            np.testing.assert_array_equal(a, b)
    ev = _jax_events(name)
    assert {k: mine.counts[k] for k in ("hit", "miss", "evict")} == {
        k: ev[k] for k in ("hit", "miss", "evict")}
    assert mine.counts["evict"] > 0 and len(mine) == len(ref) == 4
    mine.clear()
    assert len(mine) == 0 and mine.counts == {"hit": 0, "miss": 0, "evict": 0,
                                              "bypass": 0}


def test_input_cache_is_the_jax_lru():
    name = f"t_lru_{next(_names)}"
    mine = blsrt.InputCache(name, 2)
    ref = jblsrt.InputCache(name, "LHTPU_TORCH_TEST_LRU_UNSET", 2)
    for op in ["p1", "p2", "g1", "p3", "g2", "g1", "g3", "p2", "g2"]:
        kind, key = op[0], op[1]
        if kind == "p":
            mine.put(key, key * 2)
            ref.put(key, key * 2)
        else:
            assert mine.get(key) == ref.get(key)
    assert list(mine._data) == list(ref._data)
    ev = _jax_events(name)
    assert {k: mine.counts[k] for k in ("hit", "miss", "evict")} == {
        k: ev[k] for k in ("hit", "miss", "evict")}


def _pack_cases():
    k = _keys(12)
    return {
        # uniform K: the gather is the grid
        "cold": ([[k[0], k[1], k[2], k[3]], [k[4], k[5], k[6], k[7]]], None),
        # mixed K and a padding set: the scatter into a zero grid
        "mixed_k": ([[k[0]], [k[1], k[2], k[3]], [k[4], k[5]]], None),
        # more distinct keys than slots: uncached
        "bypass": ([[k[0], k[1]], [k[2], k[3]]], 3),
        # exactly as many distinct keys as slots: cached, no bypass
        "at_capacity": ([[k[0], k[1]], [k[2], k[1]]], 3),
    }


@pytest.mark.parametrize("case", ["cold", "warm", "mixed_k", "bypass", "at_capacity"])
def test_pack_matches_jax(case, fresh_caches, monkeypatch):
    """The port's pack equals JaxBackend._pack_pubkey_grid byte for byte,
    and equals the uncached pack."""
    rows, cap = _pack_cases()["cold" if case == "warm" else case]
    if cap is not None:
        monkeypatch.setenv("LHTPU_PUBKEY_CACHE", str(cap))
        cache = blsrt.PubkeyRowCache("pubkey_rows", cap)
    else:
        cache = blsrt.PUBKEY_ROW_CACHE
    sets = _sets(rows)
    S, K, n = _shape(sets)
    args = (sets, S, K, n, g1_infinity())
    uncached = torch_backend._pack_pubkey_grid(*args)
    for _ in range(2 if case == "warm" else 1):
        mine = torch_backend._pack_pubkey_grid(*args, cache)
        ref = JaxBackend._pack_pubkey_grid(*args)
        for a, b, c in zip(mine, ref, uncached):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    distinct = len({pk.to_bytes() for row in rows for pk in row})
    lanes = sum(map(len, rows))
    if case == "bypass":
        assert cache.counts["bypass"] == lanes and len(cache) == 0
    else:
        # every lane of a cold batch misses (its inserts follow the lookup)
        assert cache.counts["bypass"] == 0 and len(cache) == distinct
        assert cache.counts["miss"] == lanes
        assert cache.counts["hit"] == (lanes if case == "warm" else 0)


def test_pack_keeps_batch_rows_when_evicting(fresh_caches):
    """A batch that evicts: its hits are refreshed before its misses
    evict, so the eviction takes only rows of no lane of this batch (the
    arena of 4 slots, batch 2 shares two keys with batch 1)."""
    k = _keys(6, base=40, raw=False)  # keys from points: pubkey_cache_key
    cache = blsrt.PubkeyRowCache("pubkey_rows", 4)
    for rows in ([[k[0], k[1]], [k[2], k[3]]], [[k[4], k[2]], [k[5], k[3]]],
                 [[k[0], k[1]], [k[2], k[3]]]):
        sets = _sets(rows)
        args = (sets, *_shape(sets), g1_infinity())
        for a, b in zip(torch_backend._pack_pubkey_grid(*args, cache),
                        torch_backend._pack_pubkey_grid(*args)):
            np.testing.assert_array_equal(a, b)
    assert cache.counts["evict"] == 4 and cache.counts["bypass"] == 0


def test_table_append_and_gather_match_jax():
    pks = _keys(5, base=3)
    mine, ref = blsrt.DevicePubkeyTable(), jblsrt.DevicePubkeyTable()
    for chunk in (pks[:2], pks[2:]):
        mine.append_pubkeys(chunk)
        ref.append_pubkeys(chunk)
    assert len(mine) == len(ref) == 5 and mine.capacity == ref.capacity == 1024
    for plane, want in zip(mine.device_arrays("cpu"), (ref._host_x, ref._host_y)):
        np.testing.assert_array_equal(plane.numpy(), want)
    rows = [[0, 4], [2], [], [1, 3, 2]]
    for a, b in zip(mine.gather_args(rows, 4), ref.gather_args(rows, 4)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="infinity"):
        mine.append_pubkeys([PublicKey(g1_infinity())])
    assert len(mine) == 5


def test_table_grows_and_uploads_again_after_append():
    """device_arrays uploads once, again after an append (or growth), and
    to another device when asked; the planes are the staging's bytes."""
    table = blsrt.DevicePubkeyTable()
    table.append_pubkeys(_keys(3))
    assert table.device is None
    tx, ty = table.device_arrays("cpu")
    assert tx.dtype == torch.uint8 and tuple(tx.shape) == (1024, 48)
    assert table.device_arrays("cpu")[0] is tx  # clean: no upload
    table.append_pubkeys(_keys(2, base=90))
    tx2, _ = table.device_arrays("cpu")
    assert tx2 is not tx
    hx, hy = table.host_planes()
    np.testing.assert_array_equal(tx2.numpy()[:5], hx)
    table.append_rows(np.repeat(hx[:1], 1020, 0), np.repeat(hy[:1], 1020, 0))
    assert table.capacity == 2048 and len(table) == 1025
    np.testing.assert_array_equal(table.host_planes()[0][:5], tx2.numpy()[:5])
    assert table.device_arrays("meta")[0].device.type == "meta"
    assert table.device == torch.device("meta")


def test_table_rows_api():
    """from_planes / append_rows take uint8 [m, 48] rows only; host_planes
    gives read-only views of the n staged rows."""
    pks = _keys(4, base=21)
    src = blsrt.DevicePubkeyTable()
    src.append_pubkeys(pks)
    x, y = src.host_planes()
    assert x.shape == (4, 48) and not x.flags.writeable
    with pytest.raises(ValueError):
        x[0, 0] = 1
    copy = blsrt.DevicePubkeyTable.from_planes(x, y, 3)
    assert len(copy) == 3 and copy.capacity == 1024
    np.testing.assert_array_equal(copy.host_planes()[1], y[:3])
    with pytest.raises(ValueError, match="at least 5 rows"):
        blsrt.DevicePubkeyTable.from_planes(x, y, 5)
    with pytest.raises(ValueError, match="uint8"):
        copy.append_rows(x.astype(np.int32), y)
    with pytest.raises(ValueError, match="!="):
        copy.append_rows(x, y[:2])
    assert len(copy) == 3


def test_build_sequential_table_rows_are_the_oracle_multiples():
    """build_sequential_table(10, chunk=4) on the CPU (chunk 0 by the
    plain K3 G1 and K2 G1, two mixed-add steps): row i is the JAX
    package's g1_to_dev of (i+1) G, byte for byte."""
    n = 10
    table = blsrt.build_sequential_table(n, chunk=4, device="cpu")
    assert len(table) == n and table.capacity == 1024
    g = g1_generator()
    xs, ys, _ = g1_to_dev([g.mul(i + 1) for i in range(n)])
    hx, hy = table.host_planes()
    np.testing.assert_array_equal(hx, xs.astype(np.uint8))
    np.testing.assert_array_equal(hy, ys.astype(np.uint8))
    assert not table.device_arrays("cpu")[0][n:].any()


def test_incremental_build_matches_golden():
    n, chunk = 20, 8
    new = blsrt.build_sequential_table(n, chunk=chunk, device="cpu")
    old = blsrt._build_sequential_table_scalarmul(n, chunk=chunk, device="cpu")
    assert len(new) == len(old) == n and new.capacity == old.capacity
    for a, b in zip(new.device_arrays("cpu"), old.device_arrays("cpu")):
        assert torch.equal(a, b)


def test_build_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blsrt.build_sequential_table(4, chunk=4)


def test_compressed_pubkeys_match_jax_on_a_carried_table():
    """A JAX table's planes carried across with interop.table_from_numpy:
    the same rows, and compressed_pubkeys equal to the JAX function's and
    to the keys' own serialization."""
    pks = _keys(6, base=1234)
    ref = jblsrt.DevicePubkeyTable()
    ref.append_pubkeys(pks)
    table = interop.table_from_numpy(ref._host_x, ref._host_y, len(ref))
    assert len(table) == 6 and table.capacity == ref.capacity
    np.testing.assert_array_equal(table.device_arrays("cpu")[0].numpy(), ref._host_x)
    got = blsrt.compressed_pubkeys(table)
    np.testing.assert_array_equal(got, jblsrt.compressed_pubkeys(ref))
    assert [bytes(r) for r in got] == [pk.to_bytes() for pk in pks]
    with pytest.raises(ValueError, match="uint8"):
        interop.table_from_numpy(ref._host_x.astype(np.int32), ref._host_y, 6)


def test_host_hash_cache_serves_warm_calls(fresh_caches):
    """Host route: HTC_CACHE holds each distinct message's point; a warm
    call hits for each and gives the same rows."""
    be = TorchBackend(device="cpu", input_cache=True)
    msgs = [b"\x11" * 32, b"\x22" * 32, b"\x11" * 32]
    inf2 = g2_infinity()
    cold = be._hash_messages(msgs, 4, inf2, {})
    warm = be._hash_messages(msgs, 4, inf2, {})
    for a, b in zip(cold, warm):
        np.testing.assert_array_equal(a, b)
    assert blsrt.HTC_CACHE.counts == {"hit": 2, "miss": 2, "evict": 0, "bypass": 0}
    plain = TorchBackend(device="cpu")._hash_messages(msgs, 4, inf2, {})
    for a, b in zip(cold, plain):
        np.testing.assert_array_equal(a, b)
    assert len(blsrt.HTC_CACHE) == 2


def test_device_hash_batch_cache(fresh_caches, monkeypatch):
    """Device route (the plain versions of the hash kernels on the CPU):
    the finished distinct batch is cached under (device, route, batch); a
    warm call maps nothing and returns the same rows, as new tensors."""
    be = TorchBackend(device="cpu", device_htc=True, input_cache=True)
    msgs = [b"\x33" * 32, b"\x44" * 32]
    stages = {}
    cold = be._hash_messages(msgs, 2, g2_infinity(), stages)
    assert "htc_map" in stages
    (key, cached), = blsrt.HTC_BATCH_CACHE._data.items()
    assert key == (torch.device("cpu"), True, tuple(msgs))

    def no_map(*a, **k):
        raise AssertionError("a warm call hashed again")

    monkeypatch.setattr(torch_backend.th, "hash_to_g2_map_dev", no_map)
    stages = {}
    warm = be._hash_messages(msgs, 2, g2_infinity(), stages)
    assert "htc_map" not in stages
    for a, b, c in zip(cold, warm, cached):
        assert torch.equal(a, b) and a.data_ptr() != c.data_ptr()
    report = blsrt.input_cache_report()["htc_batches"]
    assert (report["hit"], report["miss"], report["entries"]) == (1, 1, 1)
    assert report["hit_rate"] == 0.5
    # another route or device is another key
    chained = TorchBackend(device="cpu", device_htc=True, htc_resident=False,
                           input_cache=True)
    with pytest.raises(AssertionError, match="hashed again"):
        chained._hash_messages(msgs, 2, g2_infinity(), {})


def test_input_cache_report_names_every_cache(fresh_caches):
    report = blsrt.input_cache_report()
    assert set(report) == {"pubkey_rows", "hash_to_curve", "htc_batches"}
    for entry in report.values():
        assert entry == {"hit": 0, "miss": 0, "evict": 0, "bypass": 0,
                         "entries": 0, "hit_rate": 0.0}


@pytest.mark.slow
def test_sequential_table_matches_jax_device_build():
    """The JAX package's build_sequential_table(6, chunk=4), traced and run
    on the CPU, against the port's: the same bytes."""
    ref = jblsrt.build_sequential_table(6, chunk=4)
    mine = blsrt.build_sequential_table(6, chunk=4, device="cpu")
    np.testing.assert_array_equal(mine.host_planes()[0], ref._host_x[:6])
    np.testing.assert_array_equal(mine.host_planes()[1], ref._host_y[:6])
