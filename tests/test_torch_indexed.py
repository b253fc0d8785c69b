"""The indexed verify: pubkeys gathered from the registered device table
(``blsrt.DevicePubkeyTable``) in place of the host pack, against the
pure-Python oracle, the host pack and the JAX package's declines.

The sets are those of ``tests/test_torch_backend.py`` (secret keys 7-9,
messages 0x11.. and 0x22.., the (S=2, K=2) bucket), with validator indices
0, [1, 2] into a table of their three pubkeys. The port's verifies run on
the CPU (the plain versions of the kernels); the live comparison with
``JaxBackend``'s indexed verdict is slow (it traces the JAX verify).
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu import blsrt as jblsrt
from lighthouse_tpu.crypto.bls import api as japi
from lighthouse_tpu.jax_backend import JaxBackend
from lighthouse_tpu_torch import blsrt, interop, torch_backend
from lighthouse_tpu_torch.crypto.bls import api
from lighthouse_tpu_torch.crypto.bls.curve import g1_infinity
from lighthouse_tpu_torch.torch_backend import TorchBackend

SKS = [api.SecretKey.from_int(i + 7) for i in range(3)]
PKS = [sk.public_key() for sk in SKS]
M0 = b"\x11" * 32
M1 = b"\x22" * 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def table():
    """The three pubkeys registered as validators 0, 1, 2."""
    t = blsrt.DevicePubkeyTable()
    t.append_pubkeys(PKS)
    blsrt.set_device_table(t)
    yield t
    blsrt.set_device_table(None)


def _sets(mod=api, sks=None, swap=False):
    sks = sks or SKS
    pks = [sk.public_key() for sk in sks]
    sig0 = sks[0].sign(M0)
    sig1 = mod.AggregateSignature.aggregate([sks[1].sign(M1), sks[2].sign(M1)])
    if swap:
        sig0, sig1 = sig1, sig0
    return [
        mod.SignatureSet.single_pubkey(sig0, pks[0], M0, index=0),
        mod.SignatureSet.multiple_pubkeys(sig1, [pks[1], pks[2]], M1,
                                          indices=[1, 2]),
    ]


@pytest.mark.parametrize("swap", [False, True], ids=["valid", "swapped"])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "classic"])
def test_indexed_verdict_matches_oracle(table, fused, swap):
    sets = _sets(swap=swap)
    want = api.verify_signature_sets_python(sets)
    assert want is (not swap)
    be = TorchBackend(device="cpu", fused=fused)
    assert be.verify_signature_sets(sets) is want
    assert be.last_path == "indexed"
    assert be.last_operand_device == torch.device("cpu")
    assert table.device == torch.device("cpu")


@pytest.mark.parametrize("swap", [False, True], ids=["valid", "swapped"])
def test_host_pack_on_a_decline_gives_the_same_verdict(table, swap):
    """One set without indices: the batch takes the host pack (the fused
    path), with the oracle's verdict, as the indexed path has it."""
    sets = _sets(swap=swap)
    sets[1].signing_key_indices = None
    be = TorchBackend(device="cpu", fused=True)
    assert be.verify_signature_sets(sets) is (not swap)
    assert be.last_path == "fused"


def _decline(case):
    """(sets, table) for one of the JAX package's declines, and a negative
    index, which the port also declines."""
    sets = _sets(japi, [japi.SecretKey.from_int(i + 7) for i in range(3)])
    jpks = [s for st in sets for s in st.signing_keys]
    tables = {"port": blsrt.DevicePubkeyTable(), "jax": jblsrt.DevicePubkeyTable()}
    rows = {"no_table": None, "empty": 0, "short": 2}.get(case, 3)
    if case == "wrong_length":
        sets[1].signing_key_indices = [1]
    elif case == "missing":
        sets[0].signing_key_indices = None
    elif case == "negative":
        sets[1].signing_key_indices = [1, -1]
    if rows is None:
        return sets, None, None
    for t in tables.values():
        t.append_pubkeys(jpks[:rows])
    return sets, tables["port"], tables["jax"]


DECLINES = ["no_table", "empty", "short", "wrong_length", "missing", "negative"]


@pytest.mark.parametrize("case", DECLINES)
def test_declines_take_the_host_pack(case):
    """Each decline answers None (the host pack), as the JAX package's
    _table_gather_args does on the same sets and table."""
    sets, mine, ref = _decline(case)
    try:
        blsrt.set_device_table(mine)
        jblsrt.set_device_table(ref)
        assert TorchBackend(device="cpu")._table_gather_args(sets, 2, 2) is None
        if case != "negative":  # the JAX package gathers row -1
            assert JaxBackend._table_gather_args(sets, 2, 2) is None
    finally:
        blsrt.set_device_table(None)
        jblsrt.set_device_table(None)


def test_gather_args_match_jax():
    sets, mine, ref = _decline("covered")
    try:
        blsrt.set_device_table(mine)
        jblsrt.set_device_table(ref)
        tx, ty, idx, inf = TorchBackend(device="cpu")._table_gather_args(sets, 4, 2)
        jtx, jty, jidx, jinf = JaxBackend._table_gather_args(sets, 4, 2)
    finally:
        blsrt.set_device_table(None)
        jblsrt.set_device_table(None)
    for a, b in ((idx, jidx), (inf, jinf), (tx.numpy(), np.asarray(jtx)),
                 (ty.numpy(), np.asarray(jty))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert idx.tolist() == [[0, 0], [1, 2], [0, 0], [0, 0]]
    assert inf.tolist() == [[False, True], [False, False], [True, True], [True, True]]


def test_gathered_grid_aggregates_as_the_host_pack(table):
    """The gathered and the packed grids differ on padding lanes (row 0
    under the mask against zero coordinates); their canonical affine
    aggregates are equal byte for byte."""
    sets = _sets()
    be = TorchBackend(device="cpu")
    tx, ty, idx, inf = be._table_gather_args(sets, 2, 2)
    idx = torch.from_numpy(idx).to(torch.int64)
    gathered = (tx[idx].to(torch.int32), ty[idx].to(torch.int32))
    px, py, pinf = torch_backend._pack_pubkey_grid(sets, 2, 2, 2, g1_infinity())
    packed = interop.pubkey_operands(px, py, pinf, "cpu")
    assert not torch.equal(gathered[0], packed[0][0])  # lane (0, 1)
    a = torch_backend.aggregate_pubkeys(gathered, torch.from_numpy(inf))
    b = torch_backend.aggregate_pubkeys(*packed)
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_table_on_another_device_raises(table):
    """A table uploaded to another device than the backend's is neither
    moved nor passed over for the host pack: the verify raises."""
    table.device_arrays("meta")
    be = TorchBackend(device="cpu")
    with pytest.raises(ValueError, match="lives on meta"):
        be.verify_signature_sets(_sets())
    assert table.device == torch.device("meta")
    sets = _sets()
    sets[0].signing_key_indices = None  # a decline never reaches the table
    assert be._table_gather_args(sets, 2, 2) is None


@pytest.mark.slow
@pytest.mark.parametrize("swap", [False, True], ids=["valid", "swapped"])
def test_indexed_verdict_matches_jax_backend(swap):
    """JaxBackend's indexed verify on its table, and the port's on the same
    planes carried across: the same verdict, both on the indexed path."""
    jsks = [japi.SecretKey.from_int(i + 7) for i in range(3)]
    ref = jblsrt.DevicePubkeyTable()
    ref.append_pubkeys([sk.public_key() for sk in jsks])
    sets = _sets(japi, jsks, swap=swap)
    jbe, be = JaxBackend(), TorchBackend(device="cpu", fused=True)
    try:
        jblsrt.set_device_table(ref)
        blsrt.set_device_table(interop.table_from_numpy(ref._host_x, ref._host_y,
                                                        len(ref)))
        want = bool(jbe.verify_signature_sets(sets))
        assert be.verify_signature_sets(sets) is want is (not swap)
        assert be.last_path == jbe.last_path == "indexed"
    finally:
        jblsrt.set_device_table(None)
        blsrt.set_device_table(None)
