"""Per-rank process state and the thread-local current() accessor.

The execution model of the reference package carries over: one OS
process drives every local card, so MPI ranks are *threads mapped to
devices* inside the host process (several threads may share one
card — the coll/hbm case).  Each rank owns one ProcState carrying its
identity, progress engine, pml, btl endpoints and communicator table
— the analog of the per-process globals ompi_mpi_init.c sets up.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, NamedTuple, Optional

from .progress import Progress


class LogicalDevice(NamedTuple):
    """A rank's device as a ``device_map`` may give it: the torch device
    its tensors live on, and a logical slot that tells ranks sharing
    that device apart.  Ranks with pairwise-distinct slots on one card
    form a mesh of logical devices (the mesh tier then runs all its
    per-device launches on that card) — the harness's analog of the
    reference's ``--xla_force_host_platform_device_count``."""

    device: Any
    slot: int


class ProcState:
    def __init__(self, rank: int, size: int, rte: Any) -> None:
        self.rank = rank
        self.size = size
        self.rte = rte
        self.progress = Progress()
        self.pml: Any = None
        self.btls: list = []
        self.comms: Dict[int, Any] = {}  # cid -> Communicator
        self.comm_world: Any = None
        self.comm_self: Any = None
        # torch.device owned by this rank (None in host-only worlds),
        # and its logical slot on that device (None: the whole device)
        self.device: Any = None
        self.device_slot: Optional[int] = None
        # span tracer (ompi_tpu_torch/trace); None unless trace_enable —
        # hot paths pay exactly one is-None check when tracing is off
        self.tracer: Any = None
        # ULFM failure-mitigation state (ompi_tpu_torch/ft/ulfm),
        # attached by mpi_init before pml selection; None when
        # mpi_ft_ulfm is off — hot paths pay one is-None check
        self.ulfm: Any = None
        # set when this incarnation can never finalize (an injected
        # kill): process-wide last-rank accounting stops waiting on it
        self.ulfm_dead = False
        # respawn (ompi_tpu_torch/ft/respawn): a replacement rank that
        # has not rejoined yet, and the recovery epoch it runs in
        self.respawn_joining = False
        self.ft_epoch = 0
        # respawn recovery epochs and the session cid band: both shift
        # this rank's communicator-id space (comm/communicator.py
        # EPOCH_CID_STRIDE, SESSION_CID_STRIDE), so a communicator
        # built after an in-job rank replacement never aliases a
        # pre-failure cid, and concurrently resident sessions in one
        # process never share one (trace spans, pvar bands and meeting
        # keys stay unambiguous)
        self.respawn_epoch = 0
        self.cid_band = 0
        # a rank resident in the pool (tools/dvm.py): finalize() is a run
        # boundary (flush + fence) until the pool clears it at detach
        self.serve_resident = False
        self.finalized = False
        self.initialized = False
        self.extra: Dict[str, Any] = {}

    def next_cid_local(self) -> int:
        """Lower bound for CID agreement: smallest unused local cid."""
        cid = 0
        while cid in self.comms:
            cid += 1
        return cid


_tls = threading.local()
_process_state: Optional[ProcState] = None


def set_current(state: Optional[ProcState], process_wide: bool = False) -> None:
    global _process_state
    if process_wide:
        _process_state = state
    else:
        _tls.state = state


def clear_current(state: ProcState) -> None:
    """Drop `state` from both the thread-local and process-wide
    slots (finalize path): later current() calls must raise the
    clean not-initialized error, not hand out a dead state."""
    global _process_state
    if getattr(_tls, "state", None) is state:
        _tls.state = None
    if _process_state is state:
        _process_state = None


def current() -> ProcState:
    st = getattr(_tls, "state", None)
    if st is None:
        st = _process_state
    if st is None:
        raise RuntimeError(
            "MPI is not initialized in this thread (no ProcState)")
    return st


def maybe_current() -> Optional[ProcState]:
    st = getattr(_tls, "state", None)
    return st if st is not None else _process_state
