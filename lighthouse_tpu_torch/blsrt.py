"""The input path: cross-call input caches and the device pubkey table.

Port of ``lighthouse_tpu/blsrt.py`` (its caches, ``DevicePubkeyTable``,
``build_sequential_table`` and ``compressed_pubkeys``; the dedup plan is
``dedup.py``). The port has no knobs and no metrics registry: each cache
takes its capacity as a constructor argument, with the JAX package's
defaults, and counts its own traffic in ``counts`` (hit / miss / evict /
bypass). ``TorchBackend(input_cache=True)`` turns the caches on.

* ``PUBKEY_ROW_CACHE``: Montgomery limb rows of pubkeys, keyed by their
  compressed bytes, in a numpy arena: a warm batch rebuilds its [S, K]
  grid with dict lookups and one gather, with no big-int work.
* ``HTC_CACHE``: the host oracle's hash-to-G2 point of each message.
* ``HTC_BATCH_CACHE``: the device hash's (x, y, inf) tensors of a whole
  padded distinct-message batch, keyed by device, hash route and batch:
  a warm call launches no hash kernel.

The registry lives on the device as uint8 limb planes [C, 48] per
coordinate (Montgomery form; the verify widens to int32 after the gather):
a batch whose sets carry validator indices ships an [S, K] index grid
instead of 2 x S x K x 48 limbs. Registry pubkeys are never infinity, so
no infinity plane is stored; empty lanes point at row 0 under a lane mask.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from .crypto.bls.constants import P
from .devices import next_pow2, resolve_device
from .crypto.bls.curve import g1_generator
from .ops import tkernel_calls as tc
from .ops.field import R_MONT, const
from .ops.points import FP_OPS, G1_GEN_DEV, g1_to_dev, pt_add_mixed, pt_from_affine


# ----------------------------------------------------------- input caches


def _new_counts() -> dict:
    return {"hit": 0, "miss": 0, "evict": 0, "bypass": 0}


class InputCache:
    """Bounded LRU of host values, counting its traffic in ``counts``."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = max(1, int(capacity))
        self._data: OrderedDict = OrderedDict()
        self.counts = _new_counts()

    def __len__(self) -> int:
        return len(self._data)

    def get(self, key):
        try:
            val = self._data[key]
        except KeyError:
            self.counts["miss"] += 1
            return None
        self._data.move_to_end(key)
        self.counts["hit"] += 1
        return val

    def put(self, key, value) -> None:
        self._data[key] = value
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.counts["evict"] += 1

    def clear(self) -> None:
        """Drop every entry and zero the counts."""
        self._data.clear()
        self.counts = _new_counts()


class PubkeyRowCache:
    """Bounded LRU of Montgomery limb rows of pubkeys in a numpy arena.

    The LRU maps a key to an arena slot; the arena holds int32 [cap, 48]
    x / y planes and the infinity flags, allocated at first use. A lookup
    refreshes every hit to most recently used before any insert evicts, so
    within capacity an eviction never takes a slot that this batch's index
    already names (``_pack_pubkey_grid`` bypasses the cache past it)."""

    def __init__(self, name: str, capacity: int):
        self.name = name
        self.capacity = max(2, int(capacity))
        self._slots: OrderedDict = OrderedDict()  # key -> arena row
        self._free: list[int] = []
        self._x = self._y = self._inf = None
        self.counts = _new_counts()

    def __len__(self) -> int:
        return len(self._slots)

    def _ensure_arena(self) -> None:
        if self._x is None:
            cap = self.capacity
            self._x = np.empty((cap, 48), np.int32)
            self._y = np.empty((cap, 48), np.int32)
            self._inf = np.empty((cap,), bool)
            self._free = list(range(cap))

    def lookup(self, keys):
        """keys -> (slot index int64[n], -1 for a miss; miss positions)."""
        self._ensure_arena()
        idx = np.empty(len(keys), np.int64)
        misses = []
        slots = self._slots
        for i, key in enumerate(keys):
            slot = slots.get(key)
            if slot is None:
                idx[i] = -1
                misses.append(i)
            else:
                slots.move_to_end(key)
                idx[i] = slot
        self.counts["hit"] += len(keys) - len(misses)
        self.counts["miss"] += len(misses)
        return idx, misses

    def insert(self, key, x_row, y_row, inf: bool) -> int:
        """Store one row, evicting the least recently used entry when full;
        returns the arena slot the row landed in."""
        self._ensure_arena()
        slot = self._slots.get(key)
        if slot is None:
            if not self._free:
                _, slot = self._slots.popitem(last=False)
                self.counts["evict"] += 1
            else:
                slot = self._free.pop()
            self._slots[key] = slot
        else:
            self._slots.move_to_end(key)
        self._x[slot] = x_row
        self._y[slot] = y_row
        self._inf[slot] = inf
        return slot

    def gather(self, idx):
        """Arena rows (int32 x, y; bool inf) of non-negative slot indices."""
        return (
            self._x.take(idx, axis=0),
            self._y.take(idx, axis=0),
            self._inf.take(idx),
        )

    def clear(self) -> None:
        """Drop every entry (the arena stays allocated) and zero the counts."""
        self._slots.clear()
        self._free = list(range(self.capacity)) if self._x is not None else []
        self.counts = _new_counts()


PUBKEY_ROW_CACHE = PubkeyRowCache("pubkey_rows", 65536)
HTC_CACHE = InputCache("hash_to_curve", 4096)
HTC_BATCH_CACHE = InputCache("htc_batches", 8)
_CACHES = (PUBKEY_ROW_CACHE, HTC_CACHE, HTC_BATCH_CACHE)


def pubkey_cache_key(pk):
    """The compressed serialization: cheap from affine (no square root) and
    memoized on the key by ``to_bytes``, so a point maps to one arena row
    whether its key was built from bytes or from a point."""
    return pk.to_bytes()


def reset_input_caches() -> None:
    for cache in _CACHES:
        cache.clear()


def input_cache_report() -> dict:
    """Per cache: its counts, entries and hit rate."""
    out = {}
    for cache in _CACHES:
        entry = dict(cache.counts)
        seen = entry["hit"] + entry["miss"]
        entry["entries"] = len(cache)
        entry["hit_rate"] = round(entry["hit"] / seen, 4) if seen else 0.0
        out[cache.name] = entry
    return out


# ------------------------------------------------------ device pubkey table


class DevicePubkeyTable:
    """Append-only registry of pubkeys: uint8 Montgomery limb planes staged
    on the host and mirrored on one device."""

    MIN_CAPACITY = 1024

    def __init__(self):
        self._n = 0
        self._cap = 0
        self._host_x = np.zeros((0, 48), np.uint8)
        self._host_y = np.zeros((0, 48), np.uint8)
        self._dev_x = self._dev_y = None
        self._dirty = False

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def device(self) -> torch.device | None:
        """The device of the last upload (None before the first)."""
        return None if self._dev_x is None else self._dev_x.device

    def _reserve(self, n: int) -> None:
        """Grow the staging planes to hold n rows: max(1024, next_pow2(n))."""
        if n > self._cap:
            self._cap = max(self.MIN_CAPACITY, next_pow2(n))
            for name in ("_host_x", "_host_y"):
                grown = np.zeros((self._cap, 48), np.uint8)
                grown[: self._n] = getattr(self, name)[: self._n]
                setattr(self, name, grown)

    @classmethod
    def from_planes(cls, x_u8, y_u8, n: int) -> "DevicePubkeyTable":
        """A table of the first n rows of uint8 [>= n, 48] Montgomery limb
        planes (a JAX table's ``_host_x`` / ``_host_y``, or a builder's)."""
        table = cls()
        table.append_rows(np.asarray(x_u8)[:n], np.asarray(y_u8)[:n])
        if len(table) != n:
            raise ValueError(f"expected planes of at least {n} rows, got {len(table)}")
        return table

    def host_planes(self):
        """(x, y) uint8 [n, 48]: read-only views of the staged rows."""
        x, y = self._host_x[: self._n], self._host_y[: self._n]
        x.flags.writeable = y.flags.writeable = False
        return x, y

    def append_rows(self, x_u8, y_u8) -> None:
        """Append uint8 [m, 48] Montgomery limb rows of affine points that
        are not infinity (the caller's promise: rows carry no flag)."""
        for a in (x_u8, y_u8):
            if a.dtype != np.uint8 or a.ndim != 2 or a.shape[1] != 48:
                raise ValueError(f"expected uint8 [m, 48] rows, got {a.dtype} "
                                 f"{list(a.shape)}")
        if x_u8.shape != y_u8.shape:
            raise ValueError(f"x rows {list(x_u8.shape)} != y rows {list(y_u8.shape)}")
        if not len(x_u8):
            return
        n_new = self._n + len(x_u8)
        self._reserve(n_new)
        self._host_x[self._n:n_new] = x_u8
        self._host_y[self._n:n_new] = y_u8
        self._n = n_new
        self._dirty = True

    def append_pubkeys(self, pubkeys) -> None:
        """Append PublicKey objects (affine points, never infinity). The
        upload waits for the next :meth:`device_arrays`, so a burst of
        appends costs one transfer."""
        pts = [pk.point for pk in pubkeys]
        if not pts:
            return
        xs, ys, inf = g1_to_dev(pts)
        if inf.any():
            raise ValueError("infinity pubkey cannot enter the table")
        self.append_rows(xs.astype(np.uint8), ys.astype(np.uint8))

    def device_arrays(self, device):
        """(x, y) uint8 [C, 48] on ``device``, uploaded again only when the
        table changed since the last upload or ``device`` is another one."""
        device = resolve_device(device, "DevicePubkeyTable")
        if self._dirty or self._dev_x is None or self._dev_x.device != device:
            self._dev_x = torch.from_numpy(self._host_x).to(device)
            self._dev_y = torch.from_numpy(self._host_y).to(device)
            self._dirty = False
        return self._dev_x, self._dev_y

    def gather_args(self, index_rows, K: int):
        """Per-set index lists (S rows of at most K) -> (idx int32 [S, K],
        lane_inf bool [S, K]); empty lanes point at row 0 with the mask set."""
        S = len(index_rows)
        idx = np.zeros((S, K), np.int32)
        inf = np.ones((S, K), bool)
        for i, row in enumerate(index_rows):
            n = len(row)
            idx[i, :n] = row
            inf[i, :n] = False
        return idx, inf


def _chunk_bits(lo: int, chunk: int, nbits: int) -> np.ndarray:
    """MSB-first bits int32 [chunk, nbits] of the scalars lo+1 .. lo+chunk."""
    scalars = np.arange(lo + 1, lo + chunk + 1, dtype=np.uint64)
    shifts = np.arange(nbits - 1, -1, -1, dtype=np.uint64)
    return ((scalars[:, None] >> shifts[None, :]) & 1).astype(np.int32)


def _point_lanes(x, y, chunk: int, dev):
    """One affine G1 point (Montgomery limbs [48]) on ``chunk`` lanes."""
    return tuple(const(c, dev).expand(chunk, 48).contiguous() for c in (x, y))


def _store_rows(planes, lo: int, hi: int, ax, ay, ainf) -> None:
    """Chunk rows [lo, hi) of canonical affine lanes into the host planes."""
    if bool(ainf[: hi - lo].any()):
        raise RuntimeError(f"table rows {lo}..{hi}: a point at infinity")
    for plane, a in zip(planes, (ax, ay)):
        plane[lo:hi] = a[: hi - lo].to(torch.uint8).cpu().numpy()


@torch.inference_mode()
def build_sequential_table(n: int, chunk: int = 8192,
                           device=None) -> DevicePubkeyTable:
    """The registry pk_i = (i+1) G for i < n, built on ``device`` (the card
    unless the caller says otherwise) chunk by chunk: chunk 0 is one K3 G1
    over the scalars 1..chunk with bit_length(min(n, chunk)) bits, then
    K2 G1; each later chunk is the previous one plus the stride [chunk] G,
    one batched mixed addition (plain glue on K1), then K2 G1. The rows
    come down into the host staging, canonical affine; the table uploads
    at its first :meth:`~DevicePubkeyTable.device_arrays`. Byte-equal to
    :func:`_build_sequential_table_scalarmul`."""
    dev = resolve_device(device, "build_sequential_table")
    planes = (np.empty((n, 48), np.uint8), np.empty((n, 48), np.uint8))
    gx, gy = _point_lanes(*G1_GEN_DEV, chunk, dev)
    zero_inf = torch.zeros(chunk, dtype=torch.bool, device=dev)
    nbits = max(1, int(min(n, chunk)).bit_length())
    bits = torch.from_numpy(_chunk_bits(0, chunk, nbits)).to(dev)
    ax, ay, ainf = tc.to_affine_g1(tc.scalar_mul_g1(gx, gy, zero_inf, bits))

    sx, sy, _ = g1_to_dev([g1_generator().mul(chunk)])
    stride = _point_lanes(sx[0], sy[0], chunk, dev)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        _store_rows(planes, lo, hi, ax, ay, ainf)
        if hi < n:
            P_ = pt_from_affine(FP_OPS, ax, ay, zero_inf)
            ax, ay, ainf = tc.to_affine_g1(
                pt_add_mixed(FP_OPS, P_, stride, zero_inf))
    return DevicePubkeyTable.from_planes(*planes, n)


@torch.inference_mode()
def _build_sequential_table_scalarmul(n: int, chunk: int = 8192,
                                      device=None) -> DevicePubkeyTable:
    """The golden reference of :func:`build_sequential_table`: every chunk
    runs K3 G1 from G over bit_length(n) bits, then K2 G1."""
    dev = resolve_device(device, "_build_sequential_table_scalarmul")
    planes = (np.empty((n, 48), np.uint8), np.empty((n, 48), np.uint8))
    gx, gy = _point_lanes(*G1_GEN_DEV, chunk, dev)
    zero_inf = torch.zeros(chunk, dtype=torch.bool, device=dev)
    nbits = max(1, int(n).bit_length())
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        bits = torch.from_numpy(_chunk_bits(lo, chunk, nbits)).to(dev)
        ax, ay, ainf = tc.to_affine_g1(tc.scalar_mul_g1(gx, gy, zero_inf, bits))
        _store_rows(planes, lo, hi, ax, ay, ainf)
    return DevicePubkeyTable.from_planes(*planes, n)


# The registered table: TorchBackend gathers from it for sets that carry
# validator indices.
_TABLE: DevicePubkeyTable | None = None


def set_device_table(table: DevicePubkeyTable | None) -> None:
    global _TABLE
    _TABLE = table


def get_device_table() -> DevicePubkeyTable | None:
    return _TABLE


def compressed_pubkeys(table: DevicePubkeyTable) -> np.ndarray:
    """[n, 48] uint8 compressed pubkeys of the table's rows: each
    coordinate out of Montgomery form on the host (one 384-bit product
    each), then the ZCash flags over big-endian x."""
    n = len(table)
    rinv = pow(R_MONT, -1, P)
    out = np.zeros((n, 48), np.uint8)
    xb, yb = (plane.tobytes() for plane in table.host_planes())
    for i in range(n):
        x = int.from_bytes(xb[i * 48:(i + 1) * 48], "little") * rinv % P
        y = int.from_bytes(yb[i * 48:(i + 1) * 48], "little") * rinv % P
        row = bytearray(x.to_bytes(48, "big"))
        row[0] |= 0x80  # compressed
        if y != 0 and 2 * y > P:
            row[0] |= 0x20  # the lexicographically largest y
        out[i] = np.frombuffer(bytes(row), np.uint8)
    return out
