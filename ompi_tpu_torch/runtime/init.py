"""MPI bring-up / teardown for one rank.

Mirrors the ompi_mpi_init sequence (ref: ompi/runtime/ompi_mpi_init.c:
rte init → frameworks open → pml select → modex fence → add_procs →
comm_world/self → coll select → final fence) and ompi_mpi_finalize.c's
reverse teardown.

The port carries the in-process transports only (btl/inproc and
btl/self).  Of the reference's optional planes it has the span tracer
(attached before pml selection, clock offsets measured before the
finalize fence, the per-rank dump written last), the online autotuner
(attached right after the tracer), the integrity plane (its knobs are
read at init, as the reference's obs.attach does) and the fault
injectors of the rendezvous and the RMA AM apply; telemetry, pstat,
binding, ULFM, vprotocol and live recovery are listed in ROADMAP.md as
still to port.
"""

from __future__ import annotations

import os

from ompi_tpu_torch.btl import base as btl_base
from ompi_tpu_torch.btl import inproc as _btl_inproc  # noqa: F401 (registers)
from ompi_tpu_torch.btl import self_btl as _btl_self  # noqa: F401
from ompi_tpu_torch import trace as _trace
from ompi_tpu_torch.comm.communicator import Communicator, Group
from ompi_tpu_torch.obs import integrity
from ompi_tpu_torch.pml import ob1 as _pml_ob1
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
    integrity.refresh()
    if isinstance(device, LogicalDevice):
        device, state.device_slot = device.device, device.slot
    state.device = device
    # refine the oversubscription hint with the true local-rank count
    # (thread-rank worlds know it exactly; ref: the reference
    # auto-enables yield_when_idle when ranks exceed cores)
    world = state.rte.world
    state.progress.oversubscribed = world.size > (os.cpu_count() or 1)
    # 1. select the single pml engine (ref: ompi_mpi_init.c:640)
    comp, pml_cls = _pml_ob1.pml_framework.select_one(state)
    state.pml = pml_cls(state)
    # 2. btl modules + endpoint wiring (modex happens inside init)
    modules = []
    for c in btl_base.btl_framework.components():
        modules += c.init_modules(state)
    state.btls = modules
    # publish our state for inproc peers + our device assignment for
    # the job (device ids ride the modex so a later cross-host device
    # plane can see the card map), then fence (modex sync #1, ref:
    # ompi_mpi_init.c:654-661)
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
    # 3. predefined communicators: world cid 0, self cid 1
    state.comm_world = Communicator(state, 0, Group(range(state.size)),
                                    name="MPI_COMM_WORLD")
    state.comm_self = Communicator(state, 1, Group([state.rank]),
                                   name="MPI_COMM_SELF")
    # 4. collective module stacks are installed by Communicator
    # construction itself (coll_base_comm_select analog)
    # 5. final fence before returning (sync #2, ref: :833-838)
    state.rte.fence()
    state.initialized = True
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
    # barrier, then teardown in reverse (ref: ompi_mpi_finalize.c:101)
    state.rte.fence()
    for m in state.btls:
        m.finalize()
    # autotune deregistration before the tracer dump: the process
    # tuner must stop reading this world's histograms
    from ompi_tpu_torch.coll import autotune as _autotune
    _autotune.detach(state)
    state.rte.finalize()
    # trace dump LAST: teardown spans are part of the timeline
    _trace.dump_state(state)
    state.finalized = True
    clear_current(state)
