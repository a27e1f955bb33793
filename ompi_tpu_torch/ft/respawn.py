"""Self-healing respawn: in-job rank replacement with buddy restore.

Port of the reference's ft/respawn.py, the third recovery tier.  The
ULFM layer stops a dead rank from hanging the job and offers
``Comm.shrink`` — but a fixed shape can't shrink: the mesh IS the
workload.  This module closes the loop the way ULFM's spawn-based
recovery does (Bland et al.) fused with SCR-style buddy checkpointing
(cr/buddy): the dead rank is REPLACED under its original world rank,
survivors un-fail it, and everyone resumes at full size from the
newest in-memory snapshot.

The flow, per failure:

  1. **detect** — the death becomes ULFM failure records on every
     survivor; parked ops drain with ``ERR_PROC_FAILED``.
  2. **respawn** — the launch plane brings a replacement up under the
     SAME world rank at a bumped recovery epoch: mpirun's supervision
     loop relaunches the dead process (or app shell, with every rank
     it held) with ``TPUMPI_RESPAWN=1`` + ``TPUMPI_FT_EPOCH=<E>``;
     ``testing.run_ranks(..., respawn=True)`` starts a fresh rank
     thread bound to the dead rank's device.
  3. **rejoin** — survivors and the newcomer call :func:`rejoin` on
     their full-world communicator.  Built on the ULFM put-once store:
     the lowest-ranked survivor publishes the decision (failed set +
     a cid from the epoch's band, :func:`epoch_cid_floor`); survivors
     un-fail the replaced ranks, clear per-peer pml sequence state
     (``PmlOb1.ft_reset_peer``), drop the per-comm caches keyed on the
     old incarnation, and meet the newcomer's init fences; the call
     returns a full-world communicator with an epoch-tagged cid.
  4. **restore** — the application calls ``buddy.restore(newcomm)``:
     the newcomer pulls its predecessor's checkpoint from a partner
     rank, every rank rolls back to the same sequence, and the run
     continues byte-identical to a fault-free run from that snapshot.

Epoch hygiene: completed epochs purge their consumed agreement
tickets (``ulfm.purge_tickets``).

Divergences from the reference: the reference's rejoin first drops an
in-flight filesystem checkpoint epoch (``ckpt.ft_abort``); the port
has no filesystem tier yet (``cr/ckpt.py``, ROADMAP.md A9), so no
epoch can be in flight and the call is left out until A9 brings it
back.  Its rejoin also drops compiled executables of the dead ranks'
devices (``compile_cache.drop_device``); the port has no process-wide
compiled-program cache (see ft/ulfm).  And the port's survivors revoke
the communicator they replace before they agree, as the port's shrink
does (see ``ulfm.shrink``): a survivor still parked on it, waiting on
a member that raised and left, would otherwise never arrive.  The
survivors also un-fail the replaced ranks under the world's fence cv,
under which the port delivers failure records, so a record that
reaches a survivor late cannot fail the replacement again (see
``ulfm.publish_world_failures``).

Limitations, as the reference's: failures are handled one rejoin at a
time — a second rank must not die before the previous recovery
completes, unless both deaths land in one reap window of that loop.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Set

from ompi_tpu_torch import errhandler as _eh
from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.ft import ulfm as _ulfm
from ompi_tpu_torch.mca.params import registry

_timeout_var = registry.register(
    "ft", "respawn", "timeout", 60.0, float,
    help="Deadline (s) for the respawn rejoin protocol: decision "
         "agreement, survivor clearing, and the replacement's arrival "
         "at the epoch fences")

_pv_respawned = registry.register_pvar(
    "respawn", "", "ranks_respawned",
    help="Ranks this rank has seen replaced in-job (decided failed "
         "set sizes, summed over rejoins)")
_pv_rejoins = registry.register_pvar(
    "respawn", "", "rejoins_completed",
    help="Respawn rejoin protocols this rank completed")
_pv_rejoin_us = registry.register_pvar(
    "respawn", "", "rejoin_us", var_class="highwatermark",
    help="Slowest rejoin on this rank: decision + un-fail + pml/"
         "cache hygiene + epoch fences + new communicator (us)")


def joining(state) -> bool:
    """Is this rank a respawned replacement that has not yet rejoined?
    (Applications branch on this right after init: a joining rank goes
    straight to rejoin + buddy.restore instead of starting fresh.)"""
    return bool(state.respawn_joining)


def epoch_cid_floor(cid_band: int, epoch: int) -> int:
    """The cid-space floor of ``(session band, recovery epoch)``: the
    session's outer band (``SESSION_CID_STRIDE``), then the epoch's
    band inside it (``EPOCH_CID_STRIDE``).  Rejoin mints its
    post-recovery communicator cids here, so a recovery inside a
    resident session stays inside that session's cid range."""
    from ompi_tpu_torch.comm.communicator import (EPOCH_CID_STRIDE,
                                                  MAX_RESPAWN_EPOCHS,
                                                  SESSION_CID_STRIDE)
    return (cid_band * SESSION_CID_STRIDE
            + (epoch % MAX_RESPAWN_EPOCHS) * EPOCH_CID_STRIDE)


def _dbg(state, msg: str) -> None:
    if os.environ.get("FT_DEBUG"):
        import sys
        print(f"[respawn r{state.rank}] {msg}", file=sys.stderr,
              flush=True)


def _wait_store(store, key, comm, deadline, what: str):
    """Poll the put-once store for ``key`` while ticking progress."""
    while True:
        v = store.try_get(key)
        if v is not None:
            return v
        if time.monotonic() > deadline:
            raise _eh.MPIException(
                _eh.ERR_OTHER,
                f"respawn rejoin timed out waiting for {what} "
                f"(tune ft_respawn_timeout)")
        _ulfm._tick(comm)


def _epoch_rewire(state, epoch: int) -> None:
    """Survivor-side epoch reset for a job whose ranks live in several
    processes (process ranks, app shells): epoch-scoped jobid and
    modex namespaces, transport + pml reset, re-modex, and the two
    fences that pair with the replacement's init fences (its launch
    env carries TPUMPI_FT_EPOCH=epoch, so it fences under the same
    epoch-scoped keys with a reset fence counter).  A thread world
    holding every rank resolves peers through ``world.states`` and
    takes two bare fences instead (see rejoin)."""
    rte = state.rte
    base_jobid = getattr(rte, "jobid_base", None) or rte.jobid
    rte.jobid_base = base_jobid
    rte.jobid = f"{base_jobid}:e{epoch}"
    rte._fence_count = 0
    rte.modex_epoch = epoch
    state.ft_epoch = epoch
    keep = []
    for m in state.btls:
        ft = getattr(m, "ft_reset", None)
        if ft is None or ft(epoch):
            keep.append(m)
    state.btls = keep
    state.pml.ft_reset()
    if state.device is not None:
        from ompi_tpu_torch.runtime.init import device_index
        rte.modex_put("device_id", device_index(state.device))
    rte.modex_put("node_id", getattr(rte, "node_id", 0))
    rte.modex_put("cores", os.cpu_count() or 1)
    _dbg(state, f"modex re-published; entering epoch {epoch} fence 1")
    rte.fence()
    from ompi_tpu_torch.btl import base as btl_base
    state.pml.add_procs(btl_base.wire_endpoints(state, state.btls))
    _dbg(state, "endpoints rewired; entering epoch fence 2")
    rte.fence()


def rejoin(comm, name: str = ""):
    """Collective (survivors + replacement, over the full world):
    agree on the replaced ranks, un-fail them, and return a full-world
    communicator with a fresh epoch-band cid.  Survivors call this
    after catching ``ERR_PROC_FAILED``; a replacement rank
    (``respawn.joining(state)``) calls it right after init."""
    from ompi_tpu_torch.comm.communicator import (
        EPOCH_CID_STRIDE, MAX_RESPAWN_EPOCHS, Communicator, Group)

    state = comm.state
    u = _ulfm._require(comm)
    if len(comm.group) != state.size:
        raise ValueError(
            "respawn.rejoin must run on a full-world-size communicator")
    state.progress.interrupt = None  # disarm: rejoin must not re-raise
    store = _ulfm._store(state)
    am_joining = joining(state)
    epoch = state.respawn_epoch + 1
    if epoch >= MAX_RESPAWN_EPOCHS:
        # the epoch dimension of the banded cid space is exhausted: a
        # further band would spill into the NEXT session's cid range
        raise _eh.MPIException(
            _eh.ERR_OTHER,
            f"respawn epoch limit reached ({MAX_RESPAWN_EPOCHS}); "
            "restart the job instead of recovering in place")
    base = ("respawn", epoch)
    deadline = time.monotonic() + max(1.0, _timeout_var.value)
    t0 = time.perf_counter()
    u.poll()
    _dbg(state, f"rejoin epoch {epoch} "
                f"({'joining' if am_joining else 'survivor'})")

    if am_joining:
        # run_ranks starts the replacement only after the decision
        # landed and every survivor cleared it — but poll defensively
        d = _wait_store(store, base + ("d",), comm, deadline,
                        f"epoch {epoch} decision")
    else:
        # revoke the communicator this call replaces, as shrink does:
        # a survivor still parked on it (waiting on a live member that
        # raised and left) drains with ERR_REVOKED and comes here too
        _ulfm.publish_revoke(comm)
        # shrink-shaped two-phase agreement on the failed set: each
        # survivor contributes its view put-once; the lowest-ranked
        # LIVE member (the replacement's rank is still in `failed`
        # here, so it can never lead) publishes the union + the cid
        store.put_once(base + ("c", comm.rank),
                       sorted(u.failed.intersection(comm.group)))
        while True:
            d = store.try_get(base + ("d",))
            if d is not None:
                break
            u.poll()
            live = [r for r in range(comm.size)
                    if comm.group[r] not in u.failed]
            if live and live[0] == comm.rank:
                union: Set[int] = set(
                    u.failed.intersection(comm.group))
                complete = True
                for r in range(comm.size):
                    v = store.try_get(base + ("c", r))
                    if v is not None:
                        union.update(int(x) for x in v)
                    elif comm.group[r] not in u.failed:
                        complete = False
                        break
                if complete and union:
                    store.put_once(base + ("d",), {
                        "failed": sorted(union),
                        # session band first: a recovery inside a
                        # resident session must stay inside that
                        # session's cid range (band 0 for plain jobs)
                        "cid": epoch_cid_floor(state.cid_band, epoch)
                        + store.next_cid() % EPOCH_CID_STRIDE})
                    continue
            if time.monotonic() > deadline:
                raise _eh.MPIException(
                    _eh.ERR_OTHER,
                    f"respawn rejoin decision timed out on "
                    f"{comm.name or comm.cid}")
            _ulfm._tick(comm)

    decided: Set[int] = set(int(x) for x in d["failed"])
    survivors: List[int] = [g for g in comm.group if g not in decided]
    world = getattr(state.rte, "world", None)

    if not am_joining:
        # un-fail: the decided ranks are being replaced in place.
        # Under the fence cv of a thread world — a concurrent fence
        # recomputes its quorum on every wake and must see the discard
        # atomically, and the failure records are delivered under it,
        # so every record of the dead incarnation has reached this
        # rank before it un-fails (see ulfm.publish_world_failures).
        # A process rank has no thread world: its KV fence quorum
        # follows u.failed (UlfmState._sync_rte)
        with (world._f_cv if world is not None
              else contextlib.nullcontext()):
            for g in sorted(decided):
                u.unfail(g)
            if world is not None:
                for g in decided:
                    world.ulfm_failed.discard(g)
                world._f_cv.notify_all()
        # per-peer pml sequence reset BEFORE the replacement can send
        # anything: its seq-0 traffic must match, not park behind the
        # predecessor's counters
        state.pml.ft_reset_peer(decided, state.comms)
        # put-once "cleared" barrier: the replacement may only start
        # once EVERY survivor has un-failed it — otherwise a
        # straggler's stale quorum strands a fence generation
        store.put_once(base + ("cleared", comm.rank), True)
        for r in range(comm.size):
            if comm.group[r] in decided or r == comm.rank:
                continue
            _wait_store(store, base + ("cleared", r), comm, deadline,
                        f"rank {r} to clear epoch {epoch}")
        _dbg(state, "all survivors cleared")
        if _ulfm._all_local(world):
            # the inproc btl resolves peers through world.states
            # dynamically — no transport rewire.  Two bare fences pair
            # with the replacement's two init fences (a generation
            # barrier at full quorum again now that ulfm_failed is
            # empty)
            state.rte.fence()
            state.rte.fence()
        else:
            # ranks in other processes: full epoch rewire, fences
            # pairing with the replacement's TPUMPI_FT_EPOCH init
            # fences
            _epoch_rewire(state, epoch)
        _dbg(state, "epoch fences passed")

    # hygiene on both sides: caches keyed on the old incarnation's
    # group must not survive into the epoch (the replacement's fresh
    # state has none — the calls are no-ops there)
    for c in list(state.comms.values()):
        if c is None or c is comm:
            continue
        if decided.intersection(c.group):
            _ulfm._invalidate(c)
    _ulfm._invalidate(comm)
    # epoch rollover: consumed agreement/shrink tickets are garbage
    # now (leader-only — one purge per epoch suffices)
    if survivors and state.rank == survivors[0]:
        _ulfm.purge_tickets(state)

    state.respawn_epoch = epoch
    state.respawn_joining = False

    new = Communicator(state, int(d["cid"]), Group(list(comm.group)),
                       name=name or f"world-e{epoch}")
    new.errhandler = comm.errhandler
    dur_us = int((time.perf_counter() - t0) * 1e6)
    _pv_respawned.add(len(decided))
    _pv_rejoins.add(1)
    _pv_rejoin_us.update_max(dur_us)
    _trace.instant_state(state, "respawn_rejoin", "ft",
                         epoch=epoch, cid=new.cid,
                         replaced=len(decided), us=dur_us)
    _obs.record_event(_obs.EV_RESPAWN, epoch, len(decided), dur_us,
                      rank=state.rank)
    _dbg(state, f"rejoined: cid {new.cid}, replaced {sorted(decided)}")
    return new


# -- thread-world supervision (testing.run_ranks(respawn=True)) -------------


def thread_decision(world, epoch: int, timeout: float = 60.0) -> Dict:
    """Supervisor-side wait (the inproc analog of mpirun's supervision
    loop): block until epoch's rejoin decision is published AND every
    survivor has written its "cleared" mark — only then may the
    replacement thread start, or its init fences could pair against a
    survivor still counting the dead rank in its quorum."""
    deadline = time.monotonic() + timeout
    while True:
        with world.shared_lock:
            d = world.shared.get(("respawn", epoch, "d"))
            if d is not None:
                decided = set(int(x) for x in d["failed"])
                ok = all(
                    ("respawn", epoch, "cleared", r) in world.shared
                    for r in range(world.size) if r not in decided)
                if ok:
                    return dict(d)
        if time.monotonic() > deadline:
            raise TimeoutError(
                f"respawn supervisor: epoch {epoch} decision/clearing "
                f"did not complete within {timeout}s")
        time.sleep(0.001)
