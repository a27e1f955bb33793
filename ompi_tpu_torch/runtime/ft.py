"""Live fault recovery: re-route + remap without a full job restart.

Port of the reference's runtime/ft.py, a re-design of the reference's
resilience pair — routed/radix ft_event (ref:
orte/mca/routed/radix/routed_radix.c:58 — repair the daemon overlay on
daemon loss) and rmaps/resilient (ref:
orte/mca/rmaps/resilient/rmaps_resilient.c:76+ — remap a failed node's
procs onto survivors) — for this framework's control plane.

When a node daemon dies mid-job (policy ``errmgr_base_policy =
recover`` with --ckpt-dir), the HNP does NOT tear the job down:

  1. it relaunches the dead node's ranks on a surviving daemon with a
     bumped RECOVERY EPOCH and TPUMPI_RESTART=1;
  2. it publishes the epoch in the KV store, where every surviving
     rank's watcher thread (started by mpi init) sees it and arms a
     ``JobRecovery`` interrupt on the rank's progress engine;
  3. each survivor's next blocking wait raises JobRecovery out of
     whatever collective it was parked in; the application catches it
     and calls :func:`recover`, which performs an EPOCH RESET — the
     communication stack is rebuilt exactly the way a restarted
     rank's init builds it fresh:

       * epoch-scoped jobid (fence keys) and modex namespace,
       * transports reset (tcp: new listener + dropped connections;
         shm quiesced — post-recovery traffic rides tcp),
       * pml matching and sequence state cleared, and the device
         rendezvous engine's tables,
       * the re-routed ranks taken out of ULFM's failed set,
       * endpoints re-wired from the fresh modex, every communicator's
         per-group caches dropped (``ft/ulfm.py``'s list, shared with
         shrink and respawn);

  4. every rank — restarted and surviving — then loads the latest
     complete snapshot (``cr.restore``) and resumes.  The cut line is
     the snapshot: survivors roll back with the restarted ranks, the
     global state is consistent, and the job finishes without paying
     a full relaunch or losing the warm processes of the surviving
     nodes.

Divergence from the reference (a fault of the reference, fixed in the
port's copy): the reference's ``recover`` never names ULFM, so a
re-routed rank that a survivor's transport had already declared dead
stays in ``UlfmState.failed``, and the first collective after the
recovery (``cr.restore``'s closing barrier) raises
MPI_ERR_PROC_FAILED.  The port's ``recover`` un-fails the decided
ranks before its epoch fences, under the world's fence cv where a
thread world delivers failure records, as ``respawn.rejoin`` does.

The re-published modex carries the torch device's index (none for a
host-only rank), where the reference publishes its jax device id.  A
thread world that holds every rank (``run_ranks``) resolves peers
through ``world.states``: its recovery resets the pml and the caches
and takes two bare fences, with no transport rewire.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Optional


class JobRecovery(Exception):
    """Raised out of a blocking wait when the HNP published a new
    recovery epoch: the application should call :func:`recover` and
    reload its state from the latest snapshot."""

    def __init__(self, epoch: int, info: dict) -> None:
        super().__init__(f"job recovery epoch {epoch}: "
                         f"failed ranks {info.get('failed')}")
        self.epoch = epoch
        self.info = info


def _epoch_key(epoch: int) -> str:
    return f"ft:epoch:{epoch}"


def start_watcher(state) -> None:
    """Arm the per-rank epoch watcher (called by mpi init when the
    launcher exported TPUMPI_FT_RECOVER).  A dedicated KV connection
    blocks on the next epoch key; on arrival the rank's progress
    engine gets an interrupt, so the next blocking wait raises
    JobRecovery no matter what the rank was doing."""
    from ompi_tpu_torch.runtime.kvstore import KVClient

    addr = os.environ.get("TPUMPI_KV_ADDR")
    if not addr:
        return

    def watch() -> None:
        try:
            kv = KVClient(addr)
        except (OSError, RuntimeError):
            return
        epoch = getattr(state, "ft_epoch", 0)
        while True:
            try:
                info = kv.get(_epoch_key(epoch + 1), timeout=3600.0)
            except (RuntimeError, OSError):
                if getattr(state, "finalized", False):
                    return
                continue
            epoch += 1
            state.progress.interrupt = JobRecovery(epoch, info)
            state.progress.wakeup()

    t = threading.Thread(target=watch, daemon=True,
                         name=f"ft-watcher-r{state.rank}")
    t.start()
    state._ft_watcher = t


def pending(state) -> Optional[JobRecovery]:
    """The armed-but-not-yet-raised recovery interrupt, if any."""
    exc = state.progress.interrupt
    return exc if isinstance(exc, JobRecovery) else None


def wait_pending(comm, timeout: float = 60.0) -> JobRecovery:
    """Block until the watcher arms a recovery epoch.  Used by
    applications that caught a TRANSPORT error (a dead peer's
    connection can fail a send before the HNP's epoch publication
    lands) and need the epoch before they can recover."""
    import time

    deadline = time.monotonic() + timeout
    while True:
        exc = pending(comm.state)
        if exc is not None:
            return exc
        if time.monotonic() > deadline:
            raise TimeoutError(
                "no recovery epoch announced — the failure was not "
                "a recoverable daemon loss")
        time.sleep(0.01)


def _dbg(state, msg: str) -> None:
    if os.environ.get("FT_DEBUG"):
        import sys
        print(f"[ft r{state.rank}] {msg}", file=sys.stderr, flush=True)


def recover(comm, exc: JobRecovery) -> None:
    """The surviving-rank epoch reset (see module docstring).  After
    this returns, cr.restore(comm) loads the snapshot every rank —
    restarted and surviving — resumes from."""
    import contextlib

    from ompi_tpu_torch.ft import ulfm as _ulfm

    state = comm.state
    epoch = exc.epoch
    progress = state.progress
    progress.interrupt = None  # disarm: recovery itself must not raise
    state.ft_epoch = epoch
    rte = state.rte
    world = getattr(rte, "world", None)
    local = _ulfm._all_local(world)

    if not local:
        # 1. epoch-scoped control-plane namespaces: fences and modex
        # keys match what the restarted ranks' init uses (their launch
        # env carries TPUMPI_FT_EPOCH / the epoch jobid)
        base_jobid = getattr(rte, "jobid_base", None) or rte.jobid
        rte.jobid_base = base_jobid
        rte.jobid = f"{base_jobid}:e{epoch}"
        rte._fence_count = 0
        rte.modex_epoch = epoch

        # 2. transports: tcp rebuilds (new listener, fresh modex addr
        # under the epoch namespace); shm is quiesced — its rings may
        # still hold pre-epoch frames, and a drained stale frame with
        # a reset sequence space would poison matching
        keep = []
        for m in state.btls:
            ft = getattr(m, "ft_reset", None)
            if ft is None or ft(epoch):
                keep.append(m)
        state.btls = keep

    # 3. pml: clear matching + sequence state (both ends of every
    # channel restart at zero; the snapshot line has no in-flight
    # traffic by quiesce construction), and the device-rendezvous
    # engine's tables: a stale pending entry keyed by a reusable xid
    # would satisfy a post-recovery pull with pre-epoch data
    state.pml.ft_reset()
    eng = getattr(state, "_tpu_rndv", None)
    if eng is not None:
        eng.ft_reset()

    # 4. the re-routed ranks are alive again: take them out of ULFM's
    # failed set BEFORE the epoch fences (a KV-fenced rank's quorum
    # follows it), under the world's fence cv where a thread world
    # delivers failure records, so a record of the dead incarnation
    # cannot fail the replacement after this.  (The per-peer pml
    # marks went with ft_reset above.)
    u = getattr(state, "ulfm", None)
    decided = sorted(int(g) for g in (exc.info or {}).get("failed", ()))
    if u is not None and decided:
        u.poll()
        with (world._f_cv if world is not None
              and hasattr(world, "_f_cv") else contextlib.nullcontext()):
            for g in decided:
                u.unfail(g)
            if world is not None and hasattr(world, "ulfm_failed"):
                for g in decided:
                    world.ulfm_failed.discard(g)
                world._f_cv.notify_all()

    if local:
        # the inproc btl resolves peers through world.states: no
        # rewire, two bare fences (a generation barrier at full
        # quorum)
        rte.fence()
        _invalidate_all(state)
        rte.fence()
        _dbg(state, "recover complete")
        os.environ["TPUMPI_RESTART"] = "1"
        return

    # 5. re-publish identity modex under the epoch namespace and meet
    # the restarted ranks at their init fences (sync #1)
    if state.device is not None:
        from ompi_tpu_torch.runtime.init import device_index
        rte.modex_put("device_id", device_index(state.device))
    rte.modex_put("node_id", getattr(rte, "node_id", 0))
    rte.modex_put("cores", os.cpu_count() or 1)
    if getattr(state, "_seg_modex_done", False):
        # coll/seg eligibility reads every member's (node, session)
        # under the epoch namespace too
        rte.modex_put("seg_session", rte.session_dir)
    _dbg(state, "modex re-published; entering epoch fence 1")
    rte.fence()
    _dbg(state, "epoch fence 1 passed")

    # 6. endpoints from the fresh modex; every communicator's cached
    # transport/eligibility state is stale (placement CHANGED: the
    # remapped ranks oversubscribe a survivor node, and a survivor
    # keeping a pre-failure verdict while the restarted rank computes
    # the new one would split the comm across algorithms)
    from ompi_tpu_torch.btl import base as btl_base
    endpoints = btl_base.wire_endpoints(state, state.btls)
    state.pml.add_procs(endpoints)
    _invalidate_all(state)

    # 7. init's sync #2, then let cr.restore see the restart flag
    _dbg(state, "endpoints rewired; entering epoch fence 2")
    rte.fence()
    _dbg(state, "recover complete")
    os.environ["TPUMPI_RESTART"] = "1"


def _invalidate_all(state) -> None:
    """Drop every communicator's per-group caches (``ulfm``'s list,
    the one shrink and respawn purge) and its device rendezvous."""
    from ompi_tpu_torch.ft import ulfm as _ulfm
    for c in list(state.comms.values()):
        if c is not None:
            _ulfm._invalidate(c)
