"""Tiered checkpointing: async device drain + collective-I/O durable
tier under the in-memory buddy tier.

Port of the reference's cr/ckpt.py.  A single ``ckpt.checkpoint``
call services both tiers:

  tier 1  buddy replicas (cr/buddy.py)  — every call, in-memory,
          fast restore over p2p
  tier 2  filesystem epoch (this file)  — every ``cr_fs_interval``-th
          call, written through io.file into ``cr_fs_dir``, survives
          the loss of a rank AND all its buddy partners

The filesystem tier is **asynchronous**: ``checkpoint`` only *plans*
the epoch (pickle the pytree skeleton, snapshot every array leaf,
agree on the epoch number and file offsets, open the file) — the
app-visible stall is that enqueue cost.  The pwrites happen
afterwards, ``cr_drain_depth`` shards at a time, from a low-priority
progress callback that runs while the application is back inside its
own collectives.

Snapshot, not reference.  The reference holds each jax leaf by
reference until the drain, tear-free because jax arrays are
immutable.  A torch tensor is mutable: a tensor held until the drain
would write whatever the application stored into it after
``checkpoint`` returned.  So the drain reads only the snapshot that
``cr/shard.py`` ``plan`` queued: a card tensor's device-to-host copy
into a pinned stage on the current stream, with an event after it (a
CPU tensor or numpy leaf is copied at once).  The progress tick never
blocks on the card: it takes a shard only once its event has
completed (``shard.ready``, an ``event.query()``) and leaves the rest
for a later tick; ``commit`` and ``flush`` may wait.

Two-phase commit makes torn epochs harmless:

  phase 1  every rank writes its region of ``ep_NNNNNN/data.bin``
           (async drain or, with ``cr_drain_depth 0``, one fcoll
           two-phase collective write), then fsyncs;
  phase 2  ranks send their shard manifests to rank 0, which writes
           ``manifest.json`` atomically (tmp + rename) and publishes a
           put-once commit record in the ULFM KV plane.

``manifest.json`` *is* the commit marker: a crash anywhere in phase 1
leaves a directory restore will never select.  Commit is deferred to
the *next* ``checkpoint`` call (the drain had the whole window to
finish) or an explicit ``flush``.  A rank death mid-commit surfaces as
ERR_PROC_FAILED from the collectives, the rejoin path drops the torn
epoch (``ft_abort``), and the previous committed epoch still restores.

Restore ladder (``ckpt.restore``), in order:

  1. live buddy replica
  2. filesystem epoch replay   — newest committed epoch whose every
     rank's shards pass CRC; a corrupt epoch falls back to the
     previous committed one (never a torn one)
  3. ``None``                  — caller escalates to job restart

Tensor leaves come back on the restoring rank's device.  A filesystem
restore re-seeds the buddy tier so the *next* failure is fast again.

Reference architecture: ompi/mca/io + fcoll for the collective write
path, orte/mca/sstore for epoch/manifest layout, SCR's multi-level
scheme for the tier composition (Moody et al.).
"""

from __future__ import annotations

import errno
import json
import os
import pickle
import time
import zlib
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np

from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch.cr import _keep_var as _cr_keep_var
from ompi_tpu_torch.cr import buddy as _buddy
from ompi_tpu_torch.cr import shard as _shard
from ompi_tpu_torch.mca.params import registry as _registry

_drain_depth_var = _registry.register(
    "cr", "", "drain_depth", 2, int,
    help="Device shards drained to host and written per progress "
         "tick for the async filesystem checkpoint tier.  Bounds the "
         "per-tick stall so the drain hides behind application "
         "collectives; 0 switches to synchronous mode (one fcoll "
         "collective write inside the checkpoint call)")
_fs_dir_var = _registry.register(
    "cr", "", "fs_dir", "", str,
    help="Root directory of the durable filesystem checkpoint tier "
         "(epoch directories ep_NNNNNN/ with data.bin + "
         "manifest.json).  Empty disables the tier; buddy replication "
         "alone then covers single failures only")
_fs_interval_var = _registry.register(
    "cr", "", "fs_interval", 1, int,
    help="Write a filesystem epoch every Nth ckpt.checkpoint call "
         "(buddy replicas are refreshed every call).  The decision is "
         "taken on rank 0 and broadcast so respawned replacements "
         "never diverge on the phase")

_pv_epochs = _registry.register_pvar(
    "cr", "ckpt", "epochs_committed",
    help="Filesystem checkpoint epochs this rank committed "
         "(manifest published)")
_pv_shards = _registry.register_pvar(
    "cr", "ckpt", "shards_written",
    help="Array shards this rank wrote to the filesystem tier")
_pv_bytes = _registry.register_pvar(
    "cr", "ckpt", "bytes_written",
    help="Bytes this rank wrote to the filesystem tier (residue + "
         "shards, pre-injection)")
_pv_ticks = _registry.register_pvar(
    "cr", "ckpt", "drain_ticks",
    help="Progress ticks that drained at least one pending shard")
_pv_stall = _registry.register_pvar(
    "cr", "ckpt", "stall_us", var_class="highwatermark",
    help="Worst app-visible pause of one ckpt.checkpoint call "
         "(buddy + epoch enqueue + deferred commit), microseconds")
_pv_rest_buddy = _registry.register_pvar(
    "cr", "ckpt", "restore_buddy",
    help="Restores served by the buddy tier (fast path)")
_pv_rest_fs = _registry.register_pvar(
    "cr", "ckpt", "restore_fs",
    help="Restores served by the filesystem tier (buddy replicas "
         "dead or absent)")
_pv_crc_fb = _registry.register_pvar(
    "cr", "ckpt", "crc_fallbacks",
    help="Committed epochs rejected at restore by a shard CRC "
         "mismatch, falling back to the previous epoch")
_pv_aborted = _registry.register_pvar(
    "cr", "ckpt", "epochs_aborted",
    help="In-flight epochs dropped torn (rank failure or I/O error "
         "before commit)")

# manifest entries ride the pml on an internal tag, like fcoll's
# aggregator traffic (T_META/T_DATA at -141/-142)
T_MANIFEST = -151

_MAX_CANDIDATES = 16  # committed epochs considered at restore


def _epoch_name(epoch: int) -> str:
    return "ep_%06d" % epoch


def _epoch_dir(root: str, epoch: int) -> str:
    return os.path.join(root, _epoch_name(epoch))


def _scan_epochs(root: str) -> List[int]:
    out: List[int] = []
    try:
        names = os.listdir(root)
    except OSError:
        return out
    for n in names:
        if n.startswith("ep_") and len(n) == 9 and n[3:].isdigit():
            out.append(int(n[3:]))
    return sorted(out)


def _committed_epochs(root: str) -> List[int]:
    """Committed epochs, newest first (manifest.json is the marker)."""
    out = [e for e in _scan_epochs(root)
           if os.path.exists(os.path.join(_epoch_dir(root, e),
                                          "manifest.json"))]
    out.reverse()
    return out


def _next_epoch(root: str) -> int:
    """Next unused epoch number.  Torn directories count: a number is
    never reused, so a half-written ep_N from a previous incarnation
    can never shadow a fresh commit."""
    es = _scan_epochs(root)
    return (es[-1] + 1) if es else 0


def _root(store_dir: Optional[str]) -> str:
    return store_dir or str(_fs_dir_var.value or "")


def keep_epochs() -> int:
    """Filesystem epochs retained after a commit, from the same
    ``cr_keep`` knob the cr store and buddy tier honor.  Floor of 2:
    the previous committed epoch is the CRC-fallback target and must
    survive pruning.  0 = keep all."""
    k = int(_cr_keep_var.value)
    return max(2, k) if k > 0 else 0


class _Handle:
    """One in-flight (begun, not yet committed) filesystem epoch."""

    __slots__ = ("epoch", "comm", "file", "dir", "my_off", "residue",
                 "shards", "queue", "inj", "failed", "nbytes", "t0_ns")

    def __init__(self) -> None:
        self.epoch = -1
        self.comm = None
        self.file = None
        self.dir = ""
        self.my_off = 0
        self.residue = b""
        self.shards: List[_shard.Shard] = []
        self.queue: Deque[Tuple[_shard.Shard, int]] = deque()
        self.inj = None
        self.failed: Optional[str] = None
        self.nbytes = 0
        self.t0_ns = 0  # enqueue time: the req_drain window anchor


class Engine:
    """Per-rank coordinator living in ``ProcState.extra['cr_ckpt']``.

    ``tick`` is a declared hot function (hotpath_audit): the idle path
    — no epoch in flight, or its queue already drained — must not
    allocate, because it runs on every 8th progress sweep for the rest
    of the job once a single checkpoint has been taken.
    """

    def __init__(self, state) -> None:
        self.state = state
        self.pending: Optional[_Handle] = None
        self.calls = 0
        state.progress.register(self.tick, low_priority=True)
        state.progress.register_finalize_hook(self._finalize)

    # -- async drain ----------------------------------------------------

    def tick(self) -> int:
        h = self.pending
        if h is None or not h.queue:
            return 0
        return self._drain_some(h, False)

    def _drain_some(self, h: _Handle, wait: bool = True) -> int:
        """Write up to ``cr_drain_depth`` queued shards.  ``wait``
        False (the progress tick) takes a shard only once its
        device-to-host copy has finished and stops at the first that
        has not: a progress sweep never blocks on the card."""
        depth = max(1, int(_drain_depth_var.value))
        done = 0
        while done < depth and h.queue and h.failed is None:
            if not wait and not _shard.ready(h.queue[0][0]):
                break
            sh, off = h.queue.popleft()
            try:
                _shard.drain(sh)
                self._write_shard(h, sh, off)
            except OSError as exc:
                # surfaces collectively at commit; never propagate out
                # of a progress sweep
                h.failed = str(exc)
                h.queue.clear()
                break
            sh.host = None  # bytes are on disk; drop the host copy
            done += 1
        if done:
            _pv_ticks.add(1)
            _pv_shards.add(done)
            if not h.queue and h.failed is None and h.t0_ns:
                # the epoch's async drain just finished: one req_drain
                # flight event per epoch (not per tick) so a request
                # waterfall (DESIGN.md §23) can place the drain-stall
                # window against the run it shadowed
                _obs.record_event(
                    _obs.EV_REQ_DRAIN, _obs.current_band(), h.epoch,
                    (time.perf_counter_ns() - h.t0_ns) // 1000)
                h.t0_ns = 0
        return done

    def _write_shard(self, h: _Handle, sh: _shard.Shard,
                     off: int) -> None:
        from ompi_tpu_torch.datatype import engine as dtmod
        cls = h.inj.pick() if h.inj is not None else None
        if cls == "io_stall":
            time.sleep(h.inj.delay_s)
        elif cls == "io_enospc":
            raise OSError(errno.ENOSPC,
                          "injected ENOSPC (ft_inject io_enospc)")
        nb = sh.nbytes
        host = sh.host
        if cls == "io_partial" and nb > 1:
            nb //= 2  # truncated write: the manifest CRC is over the
            host = host[:nb]  # full shard, so restore detects it
        if nb:
            h.file.write_at(off, (host, nb, dtmod.BYTE))
        _pv_bytes.add(sh.nbytes)

    # -- epoch lifecycle ------------------------------------------------

    def begin(self, comm, payload: Any, root: str) -> int:
        """Collective: plan the epoch and enqueue its shard writes.
        The app-visible cost is plan (residue pickle + numpy
        snapshots) plus the epoch agreement and collective file open
        — not the device drain or the writes."""
        from ompi_tpu_torch import ft_inject
        from ompi_tpu_torch.datatype import engine as dtmod
        from ompi_tpu_torch.io import file as iof
        from ompi_tpu_torch.op.op import SUM

        if self.pending is not None:
            raise RuntimeError("ckpt.begin: an epoch is already in "
                               "flight; commit or abort it first")
        p = _shard.plan(payload)
        h = _Handle()
        h.comm = comm
        h.residue = p.residue
        h.shards = p.shards
        h.nbytes = p.total_nbytes

        # epoch number: rank 0 scans the store, everyone follows
        e = np.array([_next_epoch(root) if comm.rank == 0 else 0],
                     dtype=np.int64)
        comm.Bcast(e, root=0)
        h.epoch = int(e[0])
        h.dir = _epoch_dir(root, h.epoch)
        os.makedirs(h.dir, exist_ok=True)

        # byte offsets: exclusive prefix sum of region sizes
        mine = np.array([h.nbytes], dtype=np.int64)
        off = np.zeros(1, dtype=np.int64)
        comm.Exscan(mine, off, SUM)
        if comm.rank == 0:
            off[0] = 0  # MPI leaves rank 0's Exscan recvbuf undefined
        h.my_off = int(off[0])

        # sharedfp=false: the engine only uses explicit offsets, so
        # the file carries no shared-pointer window — nothing polls
        # progress for the epoch's whole (possibly long) drain life
        h.file = iof.open(comm, os.path.join(h.dir, "data.bin"),
                          iof.MODE_CREATE | iof.MODE_RDWR,
                          info={"sharedfp": "false"})
        h.inj = ft_inject.io_injector(comm.rank)

        if int(_drain_depth_var.value) <= 0:
            self._write_sync(h)
        else:
            # the residue is host bytes already — write it inline (it
            # is part of the enqueue cost, like the numpy snapshots)
            if h.residue:
                h.file.write_at(
                    h.my_off,
                    (np.frombuffer(h.residue, dtype=np.uint8),
                     len(h.residue), dtmod.BYTE))
            _pv_bytes.add(len(h.residue))
            o = h.my_off + len(h.residue)
            for sh in p.shards:
                h.queue.append((sh, o))
                o += sh.nbytes
            h.t0_ns = time.perf_counter_ns()
        self.pending = h
        return h.epoch

    def _write_sync(self, h: _Handle) -> None:
        """cr_drain_depth 0: drain everything now and push the whole
        region through one fcoll two-phase collective write.  Injected
        ENOSPC is agreed *before* the collective so no rank enters it
        alone (a lone raise would strand peers in fcoll's barrier)."""
        from ompi_tpu_torch.datatype import engine as dtmod
        from ompi_tpu_torch.op.op import SUM

        comm = h.comm
        img = np.empty(h.nbytes, dtype=np.uint8)
        img[:len(h.residue)] = np.frombuffer(h.residue, dtype=np.uint8)
        o = len(h.residue)
        for sh in h.shards:
            _shard.drain(sh)
            cls = h.inj.pick() if h.inj is not None else None
            if cls == "io_stall":
                time.sleep(h.inj.delay_s)
            elif cls == "io_enospc":
                h.failed = "injected ENOSPC (ft_inject io_enospc)"
            view = img[o:o + sh.nbytes]
            view[:] = sh.host
            if cls == "io_partial" and sh.nbytes > 1:
                view[sh.nbytes // 2:] = 0  # truncation: CRC catches it
            sh.host = None
            o += sh.nbytes
        err = np.array([1 if h.failed is not None else 0],
                       dtype=np.int64)
        tot = np.zeros(1, dtype=np.int64)
        comm.Allreduce(err, tot, SUM)
        if int(tot[0]):
            return  # all ranks skip the write; commit raises together
        h.file.write_at_all(h.my_off, (img, h.nbytes, dtmod.BYTE))
        _pv_shards.add(len(h.shards))
        _pv_bytes.add(h.nbytes)

    def commit(self) -> int:
        """Collective: finish the drain, agree no rank hit an I/O
        error, fsync, gather per-rank manifests to rank 0, publish.
        Returns the committed epoch.  On an agreed I/O error the epoch
        directory is left uncommitted (restore ignores it) and OSError
        raises on every rank."""
        from ompi_tpu_torch.op.op import SUM

        h = self.pending
        if h is None:
            return -1
        comm = h.comm
        while h.queue and h.failed is None:
            self._drain_some(h)
        err = np.array([1 if h.failed is not None else 0],
                       dtype=np.int64)
        tot = np.zeros(1, dtype=np.int64)
        comm.Allreduce(err, tot, SUM)
        if int(tot[0]):
            self.pending = None
            _pv_aborted.add(1)
            _obs.record_event(_obs.EV_CKPT_ABORT, h.epoch,
                              rank=comm.rank)
            h.file.close()  # collective; every rank is in this branch
            raise OSError(
                errno.EIO,
                f"ckpt: epoch {h.epoch} aborted — I/O error on "
                f"{int(tot[0])} rank(s)"
                + (f" (local: {h.failed})" if h.failed else ""))
        h.file.sync()  # phase 1 done: my region is durable

        # phase 2: rank 0 collects every rank's manifest entry (sent
        # only after that rank's fsync) and publishes atomically
        entry = {
            "rank": comm.rank,
            "off": h.my_off,
            "nbytes": h.nbytes,
            "residue": {"off": 0, "nbytes": len(h.residue),
                        "crc": zlib.crc32(h.residue)},
            "shards": [],
        }
        o = len(h.residue)
        for sh in h.shards:
            m = sh.meta()
            m["off"] = o
            entry["shards"].append(m)
            o += sh.nbytes
        pml = comm.state.pml
        from ompi_tpu_torch.datatype import engine as dtmod
        blob = np.frombuffer(pickle.dumps(entry), dtype=np.uint8)
        req = pml.isend(blob, blob.size, dtmod.BYTE, 0, T_MANIFEST,
                        comm)
        if comm.rank == 0:
            ranks: Dict[str, Any] = {}
            for src in range(comm.size):
                st = pml.probe(src, T_MANIFEST, comm)
                data = np.empty(st.count, dtype=np.uint8)
                pml.recv(data, st.count, dtmod.BYTE, src, T_MANIFEST,
                         comm)
                ent = pickle.loads(data.tobytes())
                ranks[str(ent["rank"])] = ent
            man = {"epoch": h.epoch, "nprocs": comm.size,
                   "ranks": ranks}
            tmp = os.path.join(h.dir, "manifest.json.tmp")
            with open(tmp, "w") as fh:
                json.dump(man, fh)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, os.path.join(h.dir, "manifest.json"))
            self._publish(comm, h.epoch)
            self._prune(os.path.dirname(h.dir), h.epoch)
        req.wait()
        h.file.close()  # internal barrier: commit is global on return
        self.pending = None
        _pv_epochs.add(1)
        _obs.record_event(_obs.EV_CKPT_COMMIT, h.epoch,
                          rank=comm.rank)
        return h.epoch

    def _publish(self, comm, epoch: int) -> None:
        """Put-once commit record in the ULFM KV plane: the in-job
        half of the two-phase commit (restore candidates come from the
        store scan; the KV record lets tooling and tests observe the
        commit without touching the filesystem)."""
        from ompi_tpu_torch.ft import ulfm as _ulfm
        try:
            _ulfm._store(comm.state).put_once(
                ("cr_ckpt", "commit", epoch),
                {"epoch": epoch, "nprocs": comm.size})
        except Exception:
            pass  # the manifest rename is authoritative

    def _prune(self, root: str, epoch: int) -> None:
        import shutil
        keep = keep_epochs()
        committed = _committed_epochs(root)
        drop = committed[keep:] if keep else []
        # torn directories older than this commit are garbage: no
        # in-flight epoch can predate a committed one
        drop += [e for e in _scan_epochs(root)
                 if e < epoch and e not in committed]
        for e in drop:
            shutil.rmtree(_epoch_dir(root, e), ignore_errors=True)

    # -- teardown -------------------------------------------------------

    def abort(self) -> None:
        """Drop the in-flight epoch torn (local, non-collective: the
        job just lost ranks, so File.close's barrier is not an
        option).  The epoch directory stays on disk without a
        manifest; restore never selects it and the next commit's prune
        removes it."""
        h = self.pending
        if h is None:
            return
        self.pending = None
        h.queue.clear()
        _pv_aborted.add(1)
        _obs.record_event(_obs.EV_CKPT_ABORT, h.epoch)
        if h.file is not None:
            h.file.ft_abandon()

    def _finalize(self) -> None:
        try:
            if self.pending is not None:
                self.commit()
        finally:
            self.state.progress.unregister(self.tick)
            self.state.extra.pop("cr_ckpt", None)


def _engine(state) -> Engine:
    eng = state.extra.get("cr_ckpt")
    if eng is None:
        eng = Engine(state)
        state.extra["cr_ckpt"] = eng
    return eng


def pending_epoch(state) -> int:
    """Epoch currently in flight on this rank (-1 = none)."""
    eng = state.extra.get("cr_ckpt")
    return eng.pending.epoch if eng is not None and eng.pending else -1


# ---------------------------------------------------------------------
# public collective API
# ---------------------------------------------------------------------

def checkpoint(comm, payload: Any, store_dir: Optional[str] = None,
               fs: Optional[bool] = None) -> Tuple[int, int]:
    """Tiered collective checkpoint.  Buddy replicas refresh every
    call; a filesystem epoch is begun every ``cr_fs_interval``-th call
    (``fs=True``/``False`` overrides).  Returns ``(buddy_seq,
    fs_epoch)``, either -1 when that tier did not run.

    The previous epoch's commit is folded into this call — its drain
    had the whole inter-checkpoint window to complete, so the commit
    is normally just fsync + manifest exchange.  With no filesystem
    root configured this is a straight buddy passthrough (zero cost
    when both tiers are off)."""
    state = comm.state
    root = _root(store_dir)
    fs_epoch = -1
    if root:
        t0 = time.perf_counter()
        eng = _engine(state)
        if eng.pending is not None:
            eng.commit()
        if fs is None:
            iv = max(1, int(_fs_interval_var.value))
            d = np.array([1 if eng.calls % iv == 0 else 0],
                         dtype=np.int64)
            comm.Bcast(d, root=0)  # replacements must not diverge
            do_fs = bool(int(d[0]))
        else:
            do_fs = bool(fs)
        eng.calls += 1
        bseq = _buddy.checkpoint(comm, payload)
        if do_fs:
            fs_epoch = eng.begin(comm, payload, root)
            if int(_drain_depth_var.value) <= 0:
                eng.commit()
        _pv_stall.update_max((time.perf_counter() - t0) * 1e6)
        return bseq, fs_epoch
    return _buddy.checkpoint(comm, payload), fs_epoch


def committed_epochs(store_dir: Optional[str] = None) -> List[int]:
    """Committed filesystem epochs (manifest present), newest first.
    Local, non-collective: the DVM preemption path and tests use it
    to ask "would a restore here find durable state?" without
    touching any communicator — a preempted session's world is
    already torn down when the question matters."""
    root = _root(store_dir)
    if not root:
        return []
    return _committed_epochs(root)


def flush(comm) -> int:
    """Collective: commit the in-flight epoch now (tests, clean
    shutdown before a planned stop).  Returns the epoch, -1 if none
    was pending."""
    eng = comm.state.extra.get("cr_ckpt")
    if eng is None:
        return -1
    return eng.commit()


def ft_abort(state) -> None:
    """Drop any in-flight epoch torn after a rank failure.  Called by
    ``respawn.rejoin`` on every survivor before the world is rewired —
    an epoch begun with dead ranks can never commit (the manifest
    gather would hang), and the previous committed epoch is intact by
    two-phase construction."""
    eng = state.extra.get("cr_ckpt")
    if eng is not None:
        eng.abort()


def restore(comm, store_dir: Optional[str] = None) -> Optional[Any]:
    """Collective restore down the ladder: buddy replica first (fast
    path), filesystem epoch replay second, ``None`` when neither tier
    has a restorable snapshot (caller escalates to job restart).

    An in-flight epoch is committed first on a *healthy* world (so the
    newest state is restorable); after a failure ``rejoin`` has
    already dropped it.  A successful filesystem restore re-seeds the
    buddy tier so the next failure takes the fast path again."""
    state = comm.state
    eng = state.extra.get("cr_ckpt")
    if eng is not None and eng.pending is not None:
        eng.commit()
    try:
        out = _buddy.restore(comm)
    except RuntimeError:
        # rank + all its partners gone: the buddy tier is lost for at
        # least one rank — the collective raise is deterministic, so
        # every rank arrives here together
        out = None
    if out is not None:
        _pv_rest_buddy.add(1)
        return out
    root = _root(store_dir)
    if not root:
        return None
    out = _fs_restore(comm, root)
    if out is None:
        return None
    _pv_rest_fs.add(1)
    _buddy.checkpoint(comm, out)  # rebuild replicas on the new world
    return out


def _fs_restore(comm, root: str) -> Optional[Any]:
    from ompi_tpu_torch.datatype import engine as dtmod
    from ompi_tpu_torch.io import file as iof
    from ompi_tpu_torch.op.op import MIN

    cand = np.full(_MAX_CANDIDATES, -1, dtype=np.int64)
    if comm.rank == 0:
        es = _committed_epochs(root)[:_MAX_CANDIDATES]
        cand[:len(es)] = es
    comm.Bcast(cand, root=0)
    for e in cand:
        epoch = int(e)
        if epoch < 0:
            continue
        man = _bcast_manifest(comm, root, epoch)
        if man is None:
            continue
        entry = man["ranks"][str(comm.rank)]
        data = np.empty(int(entry["nbytes"]), dtype=np.uint8)
        try:
            f = iof.open(comm,
                         os.path.join(_epoch_dir(root, epoch),
                                      "data.bin"),
                         iof.MODE_RDONLY,
                         info={"sharedfp": "false"})
        except OSError:
            continue  # open errors are agreed: symmetric on all ranks
        if data.size:
            f.read_at_all(int(entry["off"]),
                          (data, data.size, dtmod.BYTE))
        f.close()
        ok = 1
        r = entry["residue"]
        if zlib.crc32(data[r["off"]:r["off"] + r["nbytes"]]) != r["crc"]:
            ok = 0
        for m in entry["shards"]:
            raw = data[m["off"]:m["off"] + m["nbytes"]]
            if zlib.crc32(raw) != m["crc"]:
                ok = 0
        good = np.array([ok], dtype=np.int64)
        tot = np.ones(1, dtype=np.int64)
        comm.Allreduce(good, tot, MIN)
        if not int(tot[0]):
            # a shard somewhere in the epoch is torn or corrupt: never
            # restore a damaged epoch — fall back to the previous one
            _pv_crc_fb.add(1)
            _obs.record_event(_obs.EV_CKPT_CRC_FALLBACK, epoch,
                              rank=comm.rank)
            continue
        residue = data[r["off"]:r["off"] + r["nbytes"]].tobytes()
        metas = entry["shards"]

        def fetch(i: int, _d=data, _m=metas) -> np.ndarray:
            mm = _m[i]
            return _d[mm["off"]:mm["off"] + mm["nbytes"]]

        return _shard.rebuild(residue, metas, fetch, comm.state.device)
    return None


def _bcast_manifest(comm, root: str,
                    epoch: int) -> Optional[Dict[str, Any]]:
    """Rank 0 reads + validates manifest.json, broadcasts it pickled.
    Returns None (on every rank) when it is unreadable or was written
    for a different world size."""
    blob = b""
    if comm.rank == 0:
        try:
            with open(os.path.join(_epoch_dir(root, epoch),
                                   "manifest.json")) as fh:
                man = json.load(fh)
            if int(man.get("nprocs", -1)) != comm.size:
                man = None
        except (OSError, ValueError):
            man = None
        blob = pickle.dumps(man)
    n = np.array([len(blob)], dtype=np.int64)
    comm.Bcast(n, root=0)
    buf = np.empty(int(n[0]), dtype=np.uint8)
    if comm.rank == 0:
        buf[:] = np.frombuffer(blob, dtype=np.uint8)
    comm.Bcast(buf, root=0)
    return pickle.loads(buf.tobytes())
