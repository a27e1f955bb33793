"""Checkpoint/restart: the C/R stack of the reference, the tiers that
need no MPI-IO.

Port of the reference's cr/__init__.py (a re-design of opal/mca/crs's
application-assisted ``self`` component, crcp/bkmrk's in-flight
message quiesce, snapc/full's fence + "complete" marker and sstore's
sequence directories):

  * ``Store`` — ckpt_NNNNNN/ sequence directories under one root, a
    directory without meta.json is incomplete and ignored; gzip rank
    images with a format marker.
  * ``quiesce`` — drain in-flight user traffic until every pair's
    sent/arrived envelope counts match (the pml's bookmark counters).
  * ``checkpoint`` / ``restore`` — collective over COMM_WORLD: the
    payload (tensors anywhere in it are copied to the host and come
    back on each rank's device), the buffered-eager messages the pml
    holds, and optionally a SHMEM context's symmetric heap (a host
    heap's bytes, or a device heap's shard read back from the card)
    with its allocator state.

  * ``checkpoint_local`` / ``restore_local`` — the uncoordinated tier
    (pml/vprotocol's sender-based message logging): each rank
    snapshots at its own moment under ``local_r<rank>/``, with no
    quiesce; the senders' logs replay whatever was in flight at the
    cut.

``cr/buddy.py`` is the in-memory partner tier over the same shard
image (``cr/shard.py``), and ``cr/ckpt.py`` the tiered engine that
puts an asynchronous filesystem tier (MPI-IO epochs) under it.

API (collective over COMM_WORLD):

    state = cr.restore(comm)            # None on a fresh start
    ...
    cr.checkpoint(comm, state)          # store dir from mpirun

mpirun --ckpt-dir DIR exports the store; mpirun --restart DIR (or
``python -m ompi_tpu_torch.tools.restart DIR``) relaunches into it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, List, Optional

import numpy as np

from ompi_tpu_torch.mca.params import registry as _registry

ENV_DIR = "TPUMPI_CKPT_DIR"
ENV_RESTART = "TPUMPI_RESTART"

_CKPT_GZ_MAGIC = b"TPGZ"  # pickle streams start 0x80: no collision

_compress_var = _registry.register(
    "cr", "base", "compress", True, bool,
    help="gzip rank checkpoint images (compress/gzip analog); "
         "raw images remain readable either way (format marker)")
_compress_level_var = _registry.register(
    "cr", "base", "compress_level", 1, int,
    help="gzip level for checkpoint images: 1 favors speed — the "
         "win is mostly zero pages and repeated weights")

_quiesce_timeout_var = _registry.register(
    "cr", "base", "quiesce_timeout", 60.0, float,
    help="Seconds the checkpoint quiesce may stall without counter "
         "progress before raising (bounds a hang on a lost peer)")

_keep_var = _registry.register(
    "cr", "", "keep", 0, int,
    help="Job-wide default for checkpoint(..., keep=): prune the "
         "store to the newest N complete snapshots after each commit "
         "(0 = keep all)")


# ---------------------------------------------------------------------
# payload encoding: tensors <-> host
# ---------------------------------------------------------------------

class _TensorLeaf:
    """Pickle-stable marker for a captured tensor: its dtype tag,
    shape and row-major bytes (``cr/shard.py``'s encoding)."""

    __slots__ = ("dtype", "shape", "raw")

    def __init__(self, t) -> None:
        from ompi_tpu_torch.cr import shard as _shard
        self.dtype = _shard.dtype_tag(t.dtype)
        self.shape = tuple(t.shape)
        self.raw = _shard.host_bytes(*_shard.snapshot(t)).copy()


def _encode(obj):
    # torch is imported where a payload is encoded, not with the
    # package: the launcher reads the store (Store.latest_complete)
    # on its recovery path and must not pay torch's import there
    import torch
    if isinstance(obj, torch.Tensor):
        return _TensorLeaf(obj)
    if isinstance(obj, dict):
        return {k: _encode(v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_encode(v) for v in obj)
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    return obj


def _decode(obj, device):
    if isinstance(obj, _TensorLeaf):
        from ompi_tpu_torch.cr import shard as _shard
        return _shard.tensor_from_bytes(obj.raw, obj.dtype, obj.shape,
                                        device)
    if isinstance(obj, dict):
        return {k: _decode(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_decode(v, device) for v in obj)
    if isinstance(obj, list):
        return [_decode(v, device) for v in obj]
    return obj


# ---------------------------------------------------------------------
# sstore analog: sequence directories under one root
# ---------------------------------------------------------------------

class Store:
    """ckpt_NNNNNN/ sequence dirs; a dir without meta.json is
    incomplete and ignored (snapc/full global-coordination analog:
    rank 0 writes meta only after every rank's file is fenced)."""

    def __init__(self, root: str) -> None:
        self.root = root

    def _seq_dirs(self) -> List[int]:
        if not os.path.isdir(self.root):
            return []
        out = []
        for name in os.listdir(self.root):
            if name.startswith("ckpt_"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def seq_path(self, seq: int) -> str:
        return os.path.join(self.root, f"ckpt_{seq:06d}")

    def next_seq(self) -> int:
        dirs = self._seq_dirs()
        return dirs[-1] + 1 if dirs else 0

    def latest_complete(self) -> Optional[int]:
        for seq in reversed(self._seq_dirs()):
            if os.path.exists(os.path.join(self.seq_path(seq),
                                           "meta.json")):
                return seq
        return None

    def write_rank(self, seq: int, rank: int, blob: dict) -> None:
        """Compressed (gzip) rank image with a format marker, raw
        when compression is off (ref: opal/mca/compress/gzip).  The
        4-byte magic keeps raw images readable: pickle streams begin
        with 0x80, never with the marker."""
        d = self.seq_path(seq)
        os.makedirs(d, exist_ok=True)
        tmp = os.path.join(d, f".rank_{rank}.tmp")
        with open(tmp, "wb") as f:
            if _compress_var.value:
                import gzip
                f.write(_CKPT_GZ_MAGIC)
                # stream: never hold raw + compressed images in
                # memory at once
                with gzip.GzipFile(
                        fileobj=f, mode="wb",
                        compresslevel=int(
                            _compress_level_var.value)) as gz:
                    pickle.dump(blob, gz,
                                protocol=pickle.HIGHEST_PROTOCOL)
            else:
                pickle.dump(blob, f,
                            protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, os.path.join(d, f"rank_{rank}.ckpt"))

    def read_rank(self, seq: int, rank: int) -> dict:
        with open(os.path.join(self.seq_path(seq),
                               f"rank_{rank}.ckpt"), "rb") as f:
            magic = f.read(4)
            if magic == _CKPT_GZ_MAGIC:
                import gzip
                with gzip.GzipFile(fileobj=f, mode="rb") as gz:
                    return pickle.load(gz)
            f.seek(0)
            return pickle.load(f)

    def mark_complete(self, seq: int, meta: dict) -> None:
        d = self.seq_path(seq)
        tmp = os.path.join(d, ".meta.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, os.path.join(d, "meta.json"))

    def read_meta(self, seq: int) -> dict:
        with open(os.path.join(self.seq_path(seq), "meta.json")) as f:
            return json.load(f)

    def prune(self, keep: int) -> None:
        done = [s for s in self._seq_dirs()
                if os.path.exists(os.path.join(self.seq_path(s),
                                               "meta.json"))]
        for seq in done[:-keep] if keep > 0 else []:
            shutil.rmtree(self.seq_path(seq), ignore_errors=True)


# ---------------------------------------------------------------------
# crcp/bkmrk analog: quiesce the pml
# ---------------------------------------------------------------------

def quiesce(comm, timeout: Optional[float] = None) -> None:
    """Drain in-flight user traffic: loop until every pair's
    sent/arrived envelope counts match globally and no rank holds a
    partially-transferred send.  Collective over COMM_WORLD — the
    counters are per GLOBAL rank, so a sub-communicator cannot speak
    for traffic outside itself.  Bounded: a drain that makes no
    progress within the timeout raises, naming the mismatched pairs."""
    import time

    if len(comm.group) != comm.state.size:
        raise ValueError("cr.quiesce must run on COMM_WORLD")
    if timeout is None:
        timeout = _quiesce_timeout_var.value
    pml = comm.state.pml
    n = comm.size
    me = np.empty(2 * n + 1, dtype=np.int64)
    table = np.empty((n, 2 * n + 1), dtype=np.int64)
    deadline = time.monotonic() + timeout
    last = None
    while True:
        comm.state.progress.progress()
        for j in range(n):
            me[j] = pml.cr_sent.get(comm.group[j], 0)
            me[n + j] = pml.cr_arrived.get(comm.group[j], 0)
        me[2 * n] = pml.cr_pending_sends()
        comm.Allgather(me, table)
        sent = table[:, :n]
        arrived = table[:, n:2 * n]
        if not table[:, 2 * n].any() and (sent == arrived.T).all():
            return
        snap = table.tobytes()
        if snap != last:
            last = snap  # progress: reset the stall clock
            deadline = time.monotonic() + timeout
        elif time.monotonic() > deadline:
            bad = [(i, j, int(sent[i][j]), int(arrived[j][i]))
                   for i in range(n) for j in range(n)
                   if sent[i][j] != arrived[j][i]]
            pend = [i for i in range(n) if table[i, 2 * n]]
            raise RuntimeError(
                f"cr.quiesce stalled >{timeout}s without progress: "
                f"mismatched (sender, receiver, sent, arrived) = "
                f"{bad[:8]}; ranks with partial sends: {pend} "
                f"(tune cr_base_quiesce_timeout)")


# ---------------------------------------------------------------------
# the collective checkpoint / restore API
# ---------------------------------------------------------------------

def _store_for(root: Optional[str]) -> Store:
    root = root or os.environ.get(ENV_DIR)
    if not root:
        raise RuntimeError(
            "no checkpoint store: pass store_dir= or set "
            f"{ENV_DIR}")
    return Store(root)


def _heap_bytes(ctx) -> np.ndarray:
    """A SHMEM context's own symmetric heap, as host bytes: a copy of
    the numpy heap, or the device heap's shard read back from its
    card (the read is ordered behind every op on the window)."""
    if ctx.heap is not None:
        return ctx.heap.copy()
    return ctx.win.read_local(0, ctx.heap_size).cpu().numpy()


def _heap_restore(ctx, raw: np.ndarray) -> None:
    if ctx.heap is not None:
        ctx.heap[:] = raw
        return
    ctx.win.put(raw, ctx.comm.rank, disp=0)
    ctx.win.flush_local(ctx.comm.rank)


def checkpoint(comm, payload: Any, store_dir: Optional[str] = None,
               shmem_ctx=None, keep: Optional[int] = None) -> int:
    """Collective snapshot; returns the sequence number.  ``keep``
    prunes to the newest N complete snapshots (0 = keep all; None =
    the job-wide cr_keep MCA default)."""
    if keep is None:
        keep = int(_keep_var.value)
    store = _store_for(store_dir)
    quiesce(comm)
    # quiesce stays interruptible (a recovery signal there means the
    # snapshot can't form anyway); the capture+write phases below must
    # not be torn by an armed ft interrupt — hold it until the
    # snapshot is durably complete
    with comm.state.progress.deferred_interrupts():
        from ompi_tpu_torch.pml.vprotocol import find as _vfind
        _v = _vfind(comm.state.pml)
        if _v is not None:
            # quiesce proved every logged message consumed: the
            # coordinated checkpoint is the pessimist log's GC point
            _v.clear_log()
        blob = {
            "payload": _encode(payload),
            "pml_msgs": comm.state.pml.cr_capture(),
            "rank": comm.rank,
        }
        if shmem_ctx is not None:
            blob["shmem_heap"] = _heap_bytes(shmem_ctx)
            blob["shmem_alloc"] = shmem_ctx.memheap.state()

        seq = np.array([store.next_seq() if comm.rank == 0 else 0],
                       dtype=np.int64)
        comm.Bcast(seq, root=0)
        store.write_rank(int(seq[0]), comm.rank, blob)
        comm.Barrier()  # every rank's file durably in place...
        if comm.rank == 0:
            store.mark_complete(int(seq[0]), {
                "nprocs": comm.size,
                "seq": int(seq[0]),
                "jobid": os.environ.get("TPUMPI_JOBID", ""),
            })
            if keep:
                store.prune(keep)
        comm.Barrier()  # ...before anyone trusts the snapshot exists
    return int(seq[0])


def _vlayer(comm):
    from ompi_tpu_torch.pml.vprotocol import find
    v = find(comm.state.pml)
    if v is None:
        raise RuntimeError(
            "uncoordinated checkpoint requires sender-based message "
            "logging: launch with --mca pml_vprotocol pessimist")
    return v


def checkpoint_local(comm, payload: Any,
                     store_dir: Optional[str] = None,
                     keep: Optional[int] = None) -> int:
    """UNCOORDINATED snapshot (vprotocol/pessimist): no quiesce, no
    collective, no drain — each rank snapshots at its own moment and
    writes its own sequence under ``local_r<rank>/``.  Messages
    mid-wire or arrived-but-unconsumed at the cut are NOT captured;
    the sender's log redelivers them at restore (replay), and the
    snapshotted sequence maps make redelivery exactly-once.  The
    only local contract: wait your own requests first (same as MPI
    C/R semantics)."""
    if keep is None:
        keep = int(_keep_var.value)
    store = _store_for(store_dir)
    v = _vlayer(comm)
    base = v._base
    # capture+write must not be torn by an armed ft interrupt; held,
    # not discarded — it fires right after
    with comm.state.progress.deferred_interrupts():
        blob = {
            "payload": _encode(payload),
            "vlog": v.cr_capture_vlog(),
            "replay_want": base.cr_capture_lenient(),
            "rank": comm.rank,
        }
        eng = getattr(comm.state, "_tpu_rndv", None)
        if eng is not None and eng.pending:
            # parked sender halves of chunked device transfers: without
            # them a replayed _XferHdr's pulls find nothing and the
            # receiver blocks forever.  lenient: no quiesce here, so a
            # peer mid-pull is normal — capture the full snapshot (host
            # bytes once its copy is done); a restarted receiver
            # re-pulls from chunk 0
            blob["tpu_xfers"] = eng.cr_capture(lenient=True)
        sub = Store(os.path.join(store.root, f"local_r{comm.rank}"))
        seq = sub.next_seq()
        sub.write_rank(seq, comm.rank, blob)
        sub.mark_complete(seq, {"rank": comm.rank, "seq": seq})
        if keep:
            sub.prune(keep)
        # everything this snapshot covers is now durable HERE: senders
        # may trim their logs up to these watermarks (receiver-ack GC)
        v.mark_durable(blob["vlog"]["next_seq"], blob["replay_want"])
    return seq


def restore_local(comm, store_dir: Optional[str] = None
                  ) -> Optional[Any]:
    """Restore from MY latest local (uncoordinated) snapshot, then
    replay the sender logs so every in-flight message of the cut
    line is redelivered.  Collective only in the sense that every
    rank must pass through here before user traffic resumes (the
    internal fence orders replay against restored counters).
    Tensors of the payload come back on this rank's device."""
    root = store_dir or os.environ.get(ENV_DIR)
    if not root or not os.environ.get(ENV_RESTART):
        return None
    sub = Store(os.path.join(root, f"local_r{comm.rank}"))
    seq = sub.latest_complete()
    if seq is None:
        return None
    blob = sub.read_rank(seq, comm.rank)
    v = _vlayer(comm)
    v.cr_restore_vlog(blob["vlog"])
    if blob.get("tpu_xfers"):
        from ompi_tpu_torch.btl.tpu import _engine
        _engine(comm.state).cr_restore(blob["tpu_xfers"])
    v._base._replay_want = {tuple(w) for w in blob["replay_want"]}
    # every rank's counters restored BEFORE any replay frag can
    # arrive.  The rendezvous must NOT ride the pml: a pml barrier's
    # own fragments would queue BEHIND the unreplayed sequence holes
    # (symmetric in-flight cuts deadlock).  The control-plane fence
    # (KV server) is hole-free.
    comm.state.rte.fence()
    v.replay()
    return _decode(blob["payload"], comm.state.device)


def restore(comm, store_dir: Optional[str] = None, shmem_ctx=None,
            resume: bool = False) -> Optional[Any]:
    """Returns the latest complete snapshot's payload (tensors on this
    rank's device), or None when starting fresh (no restart flag, or
    an empty store).  ``resume=True`` restores whenever the store holds
    a complete snapshot, whatever the restart flag says: a program that
    resumes itself, as a pool session replayed after its host died."""
    root = store_dir or os.environ.get(ENV_DIR)
    if not root or not (resume or os.environ.get(ENV_RESTART)):
        return None
    store = Store(root)
    seq = store.latest_complete()
    if seq is None:
        return None
    meta = store.read_meta(seq)
    if meta["nprocs"] != comm.size:
        raise RuntimeError(
            f"restart topology mismatch: snapshot has "
            f"{meta['nprocs']} ranks, job has {comm.size}")
    blob = store.read_rank(seq, comm.rank)
    comm.state.pml.cr_restore(blob["pml_msgs"])
    if shmem_ctx is not None and "shmem_heap" in blob:
        _heap_restore(shmem_ctx, blob["shmem_heap"])
        from ompi_tpu_torch.shmem import memheap as _mh
        shmem_ctx.memheap = _mh.restore(blob["shmem_alloc"],
                                        shmem_ctx.heap_size)
    out = _decode(blob["payload"], comm.state.device)
    comm.Barrier()
    return out
