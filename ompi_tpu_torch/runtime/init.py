"""MPI bring-up / teardown for one rank.

Mirrors the ompi_mpi_init sequence (ref: ompi/runtime/ompi_mpi_init.c:
rte init → frameworks open → pml select → modex fence → add_procs →
comm_world/self → coll select → final fence) and ompi_mpi_finalize.c's
reverse teardown.

Transports: btl/inproc and btl/self for thread-ranks, btl/shm and
btl/tcp between processes (a launched job's process ranks, or the app
shells of a hybrid launch).  Of the reference's optional planes it has
pstat's pvars and the binding of ``mpirun --bind-to`` (both before
pml selection), the span tracer
(attached before pml selection, clock offsets measured before the
finalize fence, the per-rank dump written last), the online autotuner
(attached right after the tracer), the telemetry plane (obs.attach:
its gauges, the flight recorder, the scrape tick, and the integrity
plane's knobs; obs.detach at finalize), the session cid band (the
predefined communicators at the band base), the fault injectors of
the rendezvous and the RMA AM apply, and ULFM (attached before pml
selection; the ``rank_kill`` arm after the final fence, never on a
respawned replacement; its store purged at finalize).  A rank
launched under mpirun's ulfm or respawn errmgr policy
(``TPUMPI_ULFM``) starts ULFM's KV note watcher after the final fence,
and a replacement launched by the respawn policy (``TPUMPI_RESPAWN``,
``TPUMPI_FT_EPOCH``) comes up joining (``ft.respawn.joining``) and
without btl/shm (the rings of a pre-failure epoch cannot be made
stale-byte-safe, so an epoch > 0 world talks over tcp).  A rank
launched under mpirun's recover policy (``TPUMPI_FT_RECOVER``) starts
the live-recovery epoch watcher (runtime/ft.py) after the final fence.
The selected pml is interposed by pml/monitoring (``pml_monitoring_
enable``) and pml/vprotocol's pessimist (``pml_vprotocol pessimist``)
on top of it; finalize writes monitoring's per-rank traffic dump
before its fence and rank 0 aggregates the matrices after it.
"""

from __future__ import annotations

import os

from ompi_tpu_torch.btl import base as btl_base
from ompi_tpu_torch.btl import inproc as _btl_inproc  # noqa: F401 (registers)
from ompi_tpu_torch.btl import self_btl as _btl_self  # noqa: F401
from ompi_tpu_torch.btl import shm as _btl_shm  # noqa: F401
from ompi_tpu_torch.btl import tcp as _btl_tcp  # noqa: F401
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.comm.communicator import (SESSION_CID_STRIDE,
                                              Communicator, Group)
from ompi_tpu_torch.pml import monitoring as _pml_monitoring
from ompi_tpu_torch.pml import ob1 as _pml_ob1
from ompi_tpu_torch.pml import vprotocol as _pml_vprotocol
from .state import LogicalDevice, ProcState, clear_current, set_current


def mpi_init(state: ProcState, device=None) -> ProcState:
    """``device`` is the ``torch.device`` this rank owns (None in a
    host-only world), or a ``LogicalDevice``: a torch device and this
    rank's logical slot on it."""
    set_current(state)
    # span tracer attach BEFORE pml/coll selection so every layer
    # constructed below can cache state.tracer (None when trace_enable
    # is off — the whole hot-path cost)
    _trace.attach(state)
    # online autotune attach rides DIRECTLY on the trace attach (it
    # force-attaches a tracer when trace_enable is off) so the pml/
    # coll layers below still cache a non-None state.tracer
    from ompi_tpu_torch.coll import autotune as _autotune
    _autotune.attach(state)
    # telemetry plane: gauges + flight recorder (idempotent across
    # looped worlds), the scrape tick when enabled, and the integrity
    # plane's knobs
    from ompi_tpu_torch import obs as _obs
    _obs.attach(state)
    if isinstance(device, LogicalDevice):
        device, state.device_slot = device.device, device.slot
    state.device = device
    # debugger attach support (MPIR analog): SIGUSR1 dumps every
    # thread's stack to stderr; crash backtraces (SIGSEGV/SIGFPE/
    # SIGABRT -> all-thread dumps) for native-code faults
    try:
        import faulthandler
        import signal as _signal
        faulthandler.register(_signal.SIGUSR1, all_threads=True,
                              chain=True)
        faulthandler.enable(all_threads=True)
    except (ImportError, AttributeError, ValueError, OSError):
        pass  # non-main thread or unsupported platform
    from ompi_tpu_torch.runtime import pstat as _pstat
    _pstat.register_pvars(state.rank)
    from ompi_tpu_torch.runtime import topology as _topo
    world = getattr(state.rte, "world", None)
    if world is not None:
        # thread-rank: sched_setaffinity(0) binds the calling THREAD.
        # The binding index is the rank's position within its NODE
        # (TPUMPI_NODE_RANK_BASE), not within its shell — two shells
        # on one node must not overlap their core assignments
        node_base = int(os.environ.get(
            "TPUMPI_NODE_RANK_BASE",
            str(getattr(world, "rank_base", 0))))
        local_rank = state.rank - node_base
    else:
        # process-rank: the launcher exports the rank's index WITHIN
        # its node
        local_rank = int(os.environ.get("TPUMPI_LOCAL_RANK", "0"))
    try:
        _topo.apply_binding(local_rank)
    except (ValueError, OSError):
        pass
    # refine the oversubscription hint with the true local-rank count:
    # thread-rank worlds know it exactly; process-ranks read the
    # launcher's TPUMPI_LOCAL_SIZE (ref: the reference auto-enables
    # yield_when_idle when ranks exceed cores)
    nlocal = getattr(world, "nlocal", None) or (
        world.size if world is not None
        else int(os.environ.get("TPUMPI_LOCAL_SIZE", "1")))
    state.progress.oversubscribed = nlocal > (os.cpu_count() or 1)
    # ULFM failure-mitigation state BEFORE pml selection so the pml
    # can cache state.ulfm (None when mpi_ft_ulfm is off — the same
    # one-is-None-check contract as the tracer)
    from ompi_tpu_torch.ft import ulfm as _ulfm
    _ulfm.attach(state)
    # the recovery epoch a launcher starts this rank in (0 for a
    # fresh job)
    state.ft_epoch = int(os.environ.get("TPUMPI_FT_EPOCH", "0"))
    # self-healing respawn (ft/respawn): a replacement launched by
    # mpirun carries TPUMPI_RESPAWN=1 and the epoch its failure opened
    # — it runs the rejoin protocol before real work and never re-arms
    # the fault that killed its predecessor.  A thread-world
    # replacement gets these attrs from run_ranks before mpi_init
    # (threads share the environment, so the env flag marks a
    # launched process or app shell only)
    if (not state.respawn_joining and os.environ.get("TPUMPI_RESPAWN")
            and getattr(state.rte, "kv", None) is not None):
        state.respawn_joining = True
        state.respawn_epoch = max(0, state.ft_epoch - 1)
    # 1. select the single pml engine (ref: ompi_mpi_init.c:640),
    # optionally interposed by pml/monitoring and, on top of it,
    # vprotocol's sender-based message logging
    comp, pml_cls = _pml_ob1.pml_framework.select_one(state)
    state.pml = _pml_vprotocol.maybe_wrap(
        _pml_monitoring.maybe_wrap(pml_cls(state), state), state)
    # 2. btl modules + endpoint wiring (modex happens inside init)
    modules = []
    for c in btl_base.btl_framework.components():
        if state.ft_epoch and getattr(c, "name", "") == "shm":
            # an epoch > 0 world keeps shm out: a constructed-then-
            # dropped module would create rings for a transport the
            # epoch never uses
            continue
        modules += c.init_modules(state)
    state.btls = modules
    # publish our state for inproc peers + our device assignment for
    # the job (device ids ride the modex so a later cross-host device
    # plane can see the card map), then fence (modex sync #1, ref:
    # ompi_mpi_init.c:654-661)
    if world is not None:
        world.states[state.rank] = state
    if device is not None:
        state.rte.modex_put("device_id", device_index(device))
    # node + cores ride the modex so collective algorithm selection
    # can be COMM-CONSISTENT about oversubscription (every member of
    # a comm must pick the same algorithm)
    state.rte.modex_put("node_id", getattr(state.rte, "node_id", 0))
    state.rte.modex_put("cores", os.cpu_count() or 1)
    state.rte.fence()
    endpoints = btl_base.wire_endpoints(state, modules)
    state.pml.add_procs(endpoints)
    # 3. predefined communicators at the band base: world cid 0, self
    # cid 1 for an ordinary job; a resident session's band shifts them
    # (next_cid floors derived comms into the same band).  The world
    # group is this JOB's rank block (world_base/world_size of a
    # launcher RTE; the whole world otherwise)
    wbase = getattr(state.rte, "world_base", 0)
    wsize = getattr(state.rte, "world_size", state.size)
    band = state.cid_band * SESSION_CID_STRIDE
    state.comm_world = Communicator(state, band,
                                    Group(range(wbase, wbase + wsize)),
                                    name="MPI_COMM_WORLD")
    from ompi_tpu_torch import attrs as _attrs
    _attrs.init_world_attrs(state.comm_world)
    state.comm_self = Communicator(state, band + 1, Group([state.rank]),
                                   name="MPI_COMM_SELF")
    # the predefined communicators' error handler is installed here
    # and only here (mpi_errhandler_world_default); derived comms
    # inherit from their parent, and the dispatch fallback for
    # handler-less objects resolves through comm_world
    from ompi_tpu_torch import errhandler as _eh
    state.comm_world.errhandler = _eh.world_default()
    state.comm_self.errhandler = state.comm_world.errhandler
    # 4. collective module stacks are installed by Communicator
    # construction itself (coll_base_comm_select analog)
    # 5. final fence before returning (sync #2, ref: :833-838)
    state.rte.fence()
    state.initialized = True
    if os.environ.get("TPUMPI_FT_RECOVER"):
        # the launcher runs the recover errmgr policy: watch for
        # recovery epochs so a daemon loss interrupts blocking waits
        # instead of hanging them (runtime/ft.py)
        from ompi_tpu_torch.runtime import ft as _ft
        _ft.start_watcher(state)
    if state.ulfm is not None:
        # ft_inject rank_kill: this rank is the victim — arm the
        # one-shot death timer (fires as a RankKilled interrupt out
        # of the next progress sweep)
        from ompi_tpu_torch import ft_inject as _fi
        if ("rank_kill" in _fi.rank_faults(state.rank, state.size)
                and not state.respawn_joining):
            # a respawned replacement never re-arms its predecessor's
            # death — that would be an infinite kill/respawn loop
            _ulfm.arm_rank_kill(state, _fi.after_s())
        if os.environ.get("TPUMPI_ULFM"):
            # mpirun runs the ulfm or respawn errmgr policy: consume
            # the job-wide ulfm:note:<n> failure/revoke records from
            # the KV store
            _ulfm.start_watcher(state)
    return state


def device_index(device) -> int:
    """The card index of a ``torch.device`` (a CPU device, or a CUDA
    device named without an index, counts as 0)."""
    return device.index if device.index is not None else 0


def device_key(state: ProcState) -> tuple:
    """What tells two ranks' devices apart: (type, card index, logical
    slot).  Ranks with one key share a device (coll/hbm); ranks with
    pairwise-distinct keys form a mesh (coll/tpu)."""
    dev = state.device
    return (dev.type, device_index(dev), state.device_slot)


def extend_universe(state: ProcState, new_size: int) -> None:
    """Make universe ranks [state.size, new_size) addressable: grow
    the endpoint table and let each btl prepare for the new peers
    (the dynamic-peer half of the reference's connect/accept
    MCA_PML_CALL(add_procs) path, ref: ompi/dpm/dpm.c)."""
    if new_size <= state.size:
        return
    old = state.size
    state.size = new_size
    for m in state.btls:
        ext = getattr(m, "extend", None)
        if ext is not None:
            ext(new_size)
    eps = list(state.pml.endpoints)
    for peer in range(old, new_size):
        reach = sorted((m for m in state.btls if m.reaches(peer)),
                       key=lambda m: -m.exclusivity)
        eps.append(btl_base.Endpoint(peer, reach) if reach else None)
    state.pml.add_procs(eps)


def mpi_finalize(state: ProcState) -> None:
    if state.finalized:
        return
    state.progress.suppress_interrupts = True
    state.progress.interrupt = None
    # flush deferred work BEFORE the fence: a flush may need one last
    # cross-rank rendezvous, so peers must still be alive here
    state.progress.run_finalize_hooks()
    # mpisync clock-offset measurement BEFORE the fence (it is itself
    # collective — Barrier/Send/Recv/Bcast need a live pml): embeds
    # the offset table into every rank's trace dump
    _trace.sync_state(state)
    # pml/monitoring traffic-matrix dump BEFORE the fence: every
    # rank's .prof file must exist by the time the fence releases
    # rank 0 to aggregate them (profile2mat semantics)
    _pml_monitoring.finalize_dump(state)
    # barrier, then teardown in reverse (ref: ompi_mpi_finalize.c:101)
    state.rte.fence()
    _pml_monitoring.finalize_aggregate(state)
    if state.ulfm is not None:
        # store hygiene: drop this world's ULFM tickets so looped
        # worlds never replay a finished run's records.  After the
        # fence (nobody agrees anymore); idempotent, so every rank
        # calling it is fine
        from ompi_tpu_torch.ft import ulfm as _ulfm
        _ulfm.purge_store(state)
    for m in state.btls:
        m.finalize()
    # autotune deregistration before the tracer dump: the process
    # tuner must stop reading this world's histograms
    from ompi_tpu_torch.coll import autotune as _autotune
    _autotune.detach(state)
    state.rte.finalize()
    # stop the scrape tick for this world (the recorder and the gauges
    # are process-scoped and survive into the next looped world)
    from ompi_tpu_torch import obs as _obs
    _obs.detach(state)
    # trace dump LAST: teardown spans are part of the timeline
    _trace.dump_state(state)
    state.finalized = True
    clear_current(state)
