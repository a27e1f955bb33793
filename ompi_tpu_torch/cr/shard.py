"""Sharded payload serialization shared by every checkpoint tier.

Port of the reference's cr/shard.py, with tensor leaves in place of
jax leaves: a payload pytree (dicts, lists, tuples) is split into

  * a **residue** — the pickled skeleton with every array leaf
    replaced by an indexed ``_ShardRef`` placeholder.  Small (shapes,
    Python scalars, dict keys), safe to materialize eagerly.
  * **shards** — one per array leaf, carrying its dtype tag, shape and
    a ``zlib.crc32`` over the raw bytes (computed on the host).

Every leaf is SNAPSHOTTED when it is planned.  The reference holds
its jax leaves by reference because jax arrays are immutable; a torch
tensor is not — an in-place write after ``plan`` would tear the
snapshot — so a tensor leaf is copied at plan time, as numpy leaves
are in both packages:

  * a card tensor goes device-to-host into a pinned stage
    (``runtime/staging.aligned_empty``), queued on the current stream
    of the tensor's device with an event recorded after it; ``drain``
    waits on that event and stamps the CRC.  The current stream is
    where the port's entry points order a tensor behind the stream
    that produced it (a collective's result behind the meeting's done
    event, ``recv_arr``'s behind the sender's copy, a window read
    behind the window's stream), so the copy reads the finished
    values, and a write enqueued later on that stream lands after it.
    The copy is never ``non_blocking`` into pageable memory: a stage
    that cannot be pinned raises.
  * a CPU tensor is copied into a 64-byte-aligned numpy stage at once.

A shard is tagged with the torch dtype's name (``"bfloat16"``, which
numpy has no type for) and carries its bytes through
``view(torch.uint8)``; ``rebuild`` puts it back on the caller's device
(a ``torch.device``, a ``LogicalDevice`` — its real device — or None
for the CPU).  Blob bytes differ from the reference's (the residue
pickles the port's class paths); the values restored are the same.

The split is what lets a filesystem tier write shard-at-a-time with
per-shard integrity, and lets buddy ship the exact bytes the durable
tier would (ref: opal/mca/crs/crs.h, orte/mca/sstore — one
serializer, many transports).
"""

from __future__ import annotations

import pickle
import struct
import zlib
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.runtime.staging import aligned_empty


class _ShardRef:
    """Pickle-stable placeholder for an extracted array leaf."""

    __slots__ = ("idx",)

    def __init__(self, idx: int) -> None:
        self.idx = idx


class Shard:
    """One array leaf of a checkpoint plan.

    ``kind`` records whether the leaf was a tensor (``"torch"``) or a
    numpy array (``"np"``) so ``rebuild`` puts it back as it came.
    ``arr`` holds the leaf's snapshot (a host stage) and ``event`` the
    end of its device-to-host copy until :func:`drain` converts it to
    ``host`` (a flat uint8 array) and stamps ``crc``.
    """

    __slots__ = ("idx", "kind", "dtype", "shape", "nbytes", "arr",
                 "event", "host", "crc")

    def __init__(self, idx: int, kind: str, dtype: str,
                 shape: Tuple[int, ...], nbytes: int) -> None:
        self.idx = idx
        self.kind = kind
        self.dtype = dtype
        self.shape = shape
        self.nbytes = nbytes
        self.arr: Any = None
        self.event: Any = None
        self.host: Optional[np.ndarray] = None
        self.crc = 0

    def meta(self) -> Dict[str, Any]:
        """JSON-safe manifest entry for this shard."""
        return {"idx": self.idx, "kind": self.kind, "dtype": self.dtype,
                "shape": list(self.shape), "nbytes": self.nbytes,
                "crc": self.crc}


class Plan:
    """A planned (but possibly not yet drained) rank snapshot."""

    __slots__ = ("residue", "shards")

    def __init__(self, residue: bytes, shards: List[Shard]) -> None:
        self.residue = residue
        self.shards = shards

    @property
    def shard_nbytes(self) -> int:
        return sum(s.nbytes for s in self.shards)

    @property
    def total_nbytes(self) -> int:
        return len(self.residue) + self.shard_nbytes


def dtype_tag(dt: torch.dtype) -> str:
    """A tensor dtype's tag: its torch name (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dt).rsplit(".", 1)[-1]


def tag_dtype(tag: str) -> torch.dtype:
    dt = getattr(torch, tag, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown tensor dtype tag {tag!r}")
    return dt


def _flat_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes, in row-major order, as a flat uint8 tensor on
    its device (a copy only where it is not contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


def snapshot(t: torch.Tensor):
    """Copy a tensor's bytes to the host now: (stage, event).  A card
    tensor's copy is queued into a pinned stage on the current stream
    of its device, ``event`` recorded after it; a CPU tensor's is done
    at once into a numpy stage (event None)."""
    flat = _flat_bytes(t)
    n = flat.numel()
    if not flat.is_cuda or n == 0:
        stage = aligned_empty(n, "cpu")
        if n:
            torch.from_numpy(stage).copy_(flat)
        return stage, None
    stage = aligned_empty(n, flat.device)
    stream = torch.cuda.current_stream(flat.device)
    stage.copy_(flat, non_blocking=True)  # pinned: a queued D2H
    ev = torch.cuda.Event()
    ev.record(stream)
    return stage, ev


def host_bytes(stage, event) -> np.ndarray:
    """The flat uint8 host bytes of a :func:`snapshot`, once its copy
    has finished (a wait only where the event has not completed yet,
    so a caller that checked :func:`ready` never waits)."""
    if event is not None and not event.query():
        event.synchronize()
    if isinstance(stage, torch.Tensor):
        return stage.numpy()
    return stage


def tensor_from_bytes(raw: np.ndarray, tag: str, shape, device
                      ) -> torch.Tensor:
    """Rebuild a tensor from its flat uint8 host bytes on ``device``
    (a torch.device, a LogicalDevice, or None for the CPU).  The
    upload is a blocking copy from pageable memory."""
    dt = tag_dtype(tag)
    shape = tuple(int(d) for d in shape)
    if raw.size == 0:
        t = torch.empty(shape, dtype=dt)
    else:
        buf = bytearray(raw.tobytes())  # private, writable
        t = torch.frombuffer(buf, dtype=torch.uint8).view(dt) \
            .reshape(shape)
    if device is None:
        return t
    return t.to(getattr(device, "device", device))


def plan(payload: Any) -> Plan:
    """Walk the payload pytree, extracting array leaves into shards.

    Every leaf is snapshotted now (see the module docstring): later
    mutation by the application cannot tear the snapshot.
    Object-dtype numpy arrays cannot be byte-sharded and stay in the
    residue pickle.
    """
    shards: List[Shard] = []

    def walk(obj):
        if isinstance(obj, torch.Tensor):
            nbytes = obj.numel() * obj.element_size()
            sh = Shard(len(shards), "torch", dtype_tag(obj.dtype),
                       tuple(obj.shape), nbytes)
            sh.arr, sh.event = snapshot(obj)
            shards.append(sh)
            return _ShardRef(sh.idx)
        if isinstance(obj, np.ndarray) and not obj.dtype.hasobject:
            dt = obj.dtype
            sh = Shard(len(shards), "np", dt.str, tuple(obj.shape),
                       int(obj.nbytes))
            sh.arr = np.array(obj, copy=True)  # snapshot: enqueue cost
            shards.append(sh)
            return _ShardRef(sh.idx)
        if isinstance(obj, dict):
            return {k: walk(v) for k, v in obj.items()}
        if isinstance(obj, tuple):
            return tuple(walk(v) for v in obj)
        if isinstance(obj, list):
            return [walk(v) for v in obj]
        return obj

    skeleton = walk(payload)
    residue = pickle.dumps(skeleton, protocol=pickle.HIGHEST_PROTOCOL)
    return Plan(residue, shards)


def ready(sh: Shard) -> bool:
    """Can :func:`drain` take this shard without waiting?  True once
    its device-to-host copy has finished (``event.query()``, which
    never blocks), and always for a host leaf or a drained shard."""
    return sh.event is None or sh.event.query()


def drain(sh: Shard) -> int:
    """Materialize a shard's host bytes (waiting on a tensor leaf's
    device-to-host copy) and stamp its CRC.  Idempotent; returns the
    shard's byte count."""
    if sh.host is None:
        if sh.kind == "torch":
            sh.host = host_bytes(sh.arr, sh.event)
        else:
            sh.host = np.ascontiguousarray(sh.arr).reshape(-1) \
                .view(np.uint8)
        sh.arr = sh.event = None
        sh.crc = zlib.crc32(sh.host)
    return sh.nbytes


def _revive(obj, leaves):
    if isinstance(obj, _ShardRef):
        return leaves[obj.idx]
    if isinstance(obj, dict):
        return {k: _revive(v, leaves) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_revive(v, leaves) for v in obj)
    if isinstance(obj, list):
        return [_revive(v, leaves) for v in obj]
    return obj


def make_leaf(meta: Dict[str, Any], raw: np.ndarray, device):
    """Rebuild one array leaf from its raw bytes + manifest meta.

    ``raw`` is a flat uint8 array (any backing).  Tensor leaves go to
    ``device``; numpy leaves come back as a private writable copy.
    """
    if meta["kind"] == "torch":
        return tensor_from_bytes(raw, meta["dtype"], meta["shape"],
                                 device)
    a = np.frombuffer(raw.tobytes(), dtype=np.dtype(meta["dtype"]))
    return np.array(a.reshape(tuple(meta["shape"])), copy=True)


def rebuild(residue: bytes, metas: List[Dict[str, Any]],
            fetch: Callable[[int], np.ndarray], device) -> Any:
    """Reassemble a payload: unpickle the residue skeleton and splice
    the array leaves back in.  ``fetch(idx)`` returns shard ``idx``'s
    raw uint8 bytes (already CRC-verified by the caller)."""
    leaves = [None] * len(metas)
    for m in metas:
        leaves[m["idx"]] = make_leaf(m, fetch(m["idx"]), device)
    return _revive(pickle.loads(residue), leaves)


# ---------------------------------------------------------------------
# self-describing one-buffer image (the buddy tier's wire format)
# ---------------------------------------------------------------------

_MAGIC = b"TPSH"  # shard image v1


def dumps(payload: Any) -> bytes:
    """Serialize a payload eagerly into one self-describing buffer:
    ``TPSH | u64 header_len | header pickle | shard bytes...``.
    Same residue/shard split and CRCs a filesystem tier writes, in one
    contiguous image the buddy ring can ship."""
    p = plan(payload)
    for sh in p.shards:
        drain(sh)
    header = pickle.dumps(
        {"residue": p.residue, "shards": [sh.meta() for sh in p.shards]},
        protocol=pickle.HIGHEST_PROTOCOL)
    parts = [_MAGIC, struct.pack("<Q", len(header)), header]
    for sh in p.shards:
        parts.append(sh.host.tobytes())
    return b"".join(parts)


def loads(data: bytes, device) -> Any:
    """Inverse of :func:`dumps`; verifies every shard CRC (a buddy
    replica that rotted in transit or in a partner's memory is caught
    here)."""
    if data[:4] != _MAGIC:
        raise ValueError("shard.loads: bad magic (not a TPSH image)")
    (hlen,) = struct.unpack_from("<Q", data, 4)
    header = pickle.loads(data[12:12 + hlen])
    metas = header["shards"]
    base = 12 + hlen
    offs: List[int] = []
    o = base
    for m in metas:
        offs.append(o)
        o += m["nbytes"]
    raws: List[np.ndarray] = []
    for i, m in enumerate(metas):
        raw = np.frombuffer(data, np.uint8, m["nbytes"], offs[i])
        crc = zlib.crc32(raw)
        if crc != m["crc"]:
            raise ValueError(
                f"shard.loads: CRC mismatch on shard {m['idx']} "
                f"(stored {m['crc']:#010x}, computed {crc:#010x})")
        raws.append(raw)
    return rebuild(header["residue"], metas, lambda i: raws[i], device)
