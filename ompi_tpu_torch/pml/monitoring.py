"""pml/monitoring: interposition layer counting traffic per peer.

Port of the reference's pml/monitoring.py, a re-design of ompi/mca/pml/monitoring (ref: pml_monitoring.h:26-41 —
a pml component that layers itself over the real pml and counts
messages/bytes per destination, splitting user traffic from internal
"filtered" traffic by tag sign; results surface as MPI_T pvars and a
dumpable traffic matrix, cf. test/monitoring/monitoring_prof.c +
profile2mat.pl).

Enable with ``--mca pml_monitoring_enable 1`` (or programmatically via
``registry.set``); mpi_init then wraps the selected pml engine.  The
wrapper delegates everything it doesn't instrument, so ob1 internals
(matching, rndv, progress) are untouched — interposition, not
modification, exactly like the reference.

The device collectives never touch the pml: ``coll/device.py`` counts
each rank's deposit into a meeting with ``count_offload`` (a card
tensor's ``numel * element_size`` bytes, 0 for a tuple value — a fused
batch's or a mesh segment's pair — as in the reference).  With
monitoring off that hook is one ``isinstance`` check; on, it takes
only the depositing rank's own matrix lock.

Where the port goes past the reference: the finalize-time dump also
writes the internal traffic (``{path}_filtered``: the offloaded
collectives are internal traffic, so the user matrices never show
them), as Open MPI's own dump does with its "I" lines.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.pml.request import ANY_TAG

enable_var = registry.register(
    "pml", "monitoring", "enable", False, bool,
    help="Interpose the monitoring layer over the selected pml and "
         "count per-peer messages/bytes (user vs internal traffic)")

dump_path_var = registry.register(
    "pml", "monitoring", "dump_path", "", str,
    help="Prefix for the finalize-time traffic-matrix dump: each rank "
         "writes {path}.{rank}.prof ('src dst msgs bytes' lines) and "
         "rank 0 aggregates them into {path}_msg.mat / _size.mat / "
         "_avg.mat (profile2mat.pl semantics); the internal traffic "
         "(offloaded collectives included) likewise under "
         "{path}_filtered")


def _internal(tag: int) -> bool:
    """Internal traffic posts exact negative tags; ANY_TAG (-1) is a
    user-side wildcard, never an internal tag."""
    return tag < 0 and tag != ANY_TAG


class _Matrix:
    """Per-peer counters: messages and bytes, user vs internal."""

    def __init__(self, size: int) -> None:
        self.msgs = [0] * size
        self.bytes = [0] * size
        self.filtered_msgs = [0] * size
        self.filtered_bytes = [0] * size

    def count(self, peer: int, nbytes: int, internal: bool) -> None:
        if internal:
            self.filtered_msgs[peer] += 1
            self.filtered_bytes[peer] += nbytes
        else:
            self.msgs[peer] += 1
            self.bytes[peer] += nbytes


def _current_monitor() -> Optional["MonitoringPml"]:
    """The calling thread-rank's monitoring layer, if interposed.
    Pvar getters resolve through here so the process-global registry
    serves every rank (each thread-rank reads ITS matrix)."""
    from ompi_tpu_torch.runtime import state as statemod
    st = statemod.maybe_current()
    pml = getattr(st, "pml", None) if st is not None else None
    return pml if isinstance(pml, MonitoringPml) else None


def _row(attr_outer: str, attr_inner: str):
    def getter():
        mon = _current_monitor()
        if mon is None:
            return []
        return list(getattr(getattr(mon, attr_outer), attr_inner))
    return getter


# pvars registered once at import (ref: the reference registers its
# pvars at component init; values resolve per-rank at read time)
registry.register_pvar("pml", "monitoring", "messages_count",
                       "Messages sent per peer (user traffic)",
                       "size", getter=_row("sent", "msgs"))
registry.register_pvar("pml", "monitoring", "messages_size",
                       "Bytes sent per peer (user traffic)",
                       "size", getter=_row("sent", "bytes"))
registry.register_pvar("pml", "monitoring", "filtered_count",
                       "Internal (tag<0) messages sent per peer",
                       "size", getter=_row("sent", "filtered_msgs"))
registry.register_pvar("pml", "monitoring", "filtered_size",
                       "Internal (tag<0) bytes sent per peer",
                       "size", getter=_row("sent", "filtered_bytes"))


class MonitoringPml:
    """Wraps the real pml; counts on the send and receive paths."""

    def __init__(self, pml, state) -> None:
        self._pml = pml
        self._state = state
        self.sent = _Matrix(state.size)
        self.recvd = _Matrix(state.size)
        # per-instance: each thread-rank only mutates its own matrix
        self._lock = threading.Lock()

    # -- instrumented entry points --------------------------------------
    def _peer_global(self, comm, peer: int) -> Optional[int]:
        if peer is None or peer < 0 or peer >= comm.size:
            return None
        return comm.group[peer]

    def _count_send(self, comm, dst, count, datatype, tag) -> None:
        g = self._peer_global(comm, dst)
        if g is None:
            return
        with self._lock:
            self.sent.count(g, count * datatype.size, _internal(tag))

    def _count_recv_status(self, comm, status) -> None:
        if status is None or status.source is None or status.source < 0:
            return
        g = self._peer_global(comm, status.source)
        if g is None:
            return
        with self._lock:
            self.recvd.count(g, status.count, _internal(status.tag))

    def send(self, buf, count, datatype, dst, tag, comm, *a, **kw):
        self._count_send(comm, dst, count, datatype, tag)
        return self._pml.send(buf, count, datatype, dst, tag, comm,
                              *a, **kw)

    def isend(self, buf, count, datatype, dst, tag, comm, *a, **kw):
        self._count_send(comm, dst, count, datatype, tag)
        return self._pml.isend(buf, count, datatype, dst, tag, comm,
                               *a, **kw)

    def recv(self, buf, count, datatype, src, tag, comm, *a, **kw):
        st = self._pml.recv(buf, count, datatype, src, tag, comm, *a, **kw)
        self._count_recv_status(comm, st)
        return st

    # irecv completion is asynchronous; count at post time with the
    # posted size (upper bound), like the reference counts at the pml
    # entry rather than at completion
    def irecv(self, buf, count, datatype, src, tag, comm, *a, **kw):
        req = self._pml.irecv(buf, count, datatype, src, tag, comm,
                              *a, **kw)
        g = self._peer_global(comm, src) if src is not None and src >= 0 \
            else None
        if g is not None:
            with self._lock:
                self.recvd.count(g, count * datatype.size, _internal(tag))
        return req

    # everything else passes straight through (probe/improbe/mrecv/
    # add_procs/progress/state_comm_peer/cancel...)
    def __getattr__(self, name):
        return getattr(self._pml, name)

    # -- reporting -------------------------------------------------------
    def matrix_rows(self) -> Dict[str, List[int]]:
        with self._lock:
            return {
                "sent_msgs": list(self.sent.msgs),
                "sent_bytes": list(self.sent.bytes),
                "sent_filtered_msgs": list(self.sent.filtered_msgs),
                "sent_filtered_bytes": list(self.sent.filtered_bytes),
                "recv_msgs": list(self.recvd.msgs),
                "recv_bytes": list(self.recvd.bytes),
            }

    def dump(self, path: str, filtered: bool = False) -> None:
        """One 'src dst msgs bytes' line per nonzero peer (the
        profile2mat.pl input format): the user traffic, or with
        ``filtered`` the internal traffic (tag < 0, the offloaded
        collectives included)."""
        me = self._state.rank
        msgs, nbytes = (self.sent.filtered_msgs, self.sent.filtered_bytes) \
            if filtered else (self.sent.msgs, self.sent.bytes)
        with open(path, "w") as fh:
            for peer in range(self._state.size):
                if msgs[peer] or nbytes[peer]:
                    fh.write(f"{me} {peer} {msgs[peer]} {nbytes[peer]}\n")


def count_offload(comm, nbytes: int) -> None:
    """Count a collective that bypassed the pml entirely (sm/device
    rendezvous: the collective happens in shared memory or on-device,
    ref coll/sm's shared segment which the reference's pml/monitoring
    also cannot see).  We do better than the reference here: the coll
    modules report the traffic the pml WOULD have carried — one
    internal message of ``nbytes`` to every other member — so the
    observability story survives the offload fast paths."""
    pml = getattr(comm.state, "pml", None)
    if not isinstance(pml, MonitoringPml):
        return
    me = comm.rank
    with pml._lock:
        for r in range(comm.size):
            if r != me:
                pml.sent.count(comm.group[r], nbytes, True)


def maybe_wrap(pml, state):
    """Called from mpi_init after pml selection (the reference winning
    component interposes the same way at init)."""
    if registry.lookup("pml", "monitoring", "enable", False):
        return MonitoringPml(pml, state)
    return pml


def _find_monitor(state) -> Optional[MonitoringPml]:
    """Unwrap the pml interposition chain (vprotocol may sit on top of
    monitoring) down to the MonitoringPml layer, if present."""
    pml = getattr(state, "pml", None)
    seen = 0
    while pml is not None and seen < 8:
        if isinstance(pml, MonitoringPml):
            return pml
        pml = pml.__dict__.get("_pml")
        seen += 1
    return None


def finalize_dump(state) -> None:
    """Per-rank finalize-time dump (called from mpi_finalize BEFORE the
    fence so every rank's .prof exists when rank 0 aggregates): the
    user traffic in {path}.{rank}.prof, as the reference, and the
    internal traffic in {path}_filtered.{rank}.prof — a step the
    reference has not (Open MPI's own dump writes both, as its "E" and
    "I" lines): an offloaded collective is internal traffic, so only
    this file shows it."""
    path = registry.lookup("pml", "monitoring", "dump_path", "")
    if not path:
        return
    mon = _find_monitor(state)
    if mon is None:
        return
    try:
        mon.dump(f"{path}.{state.rank}.prof")
        mon.dump(f"{path}_filtered.{state.rank}.prof", filtered=True)
    except OSError:
        pass  # an unwritable dump path must not break finalize


def finalize_aggregate(state) -> None:
    """Rank 0 merges the per-rank .prof files into the three matrices
    (called AFTER the fence — all dumps are on disk by then), the
    internal traffic's into {path}_filtered_msg.mat / _size.mat /
    _avg.mat."""
    path = registry.lookup("pml", "monitoring", "dump_path", "")
    if not path or _find_monitor(state) is None:
        return
    world = getattr(state, "comm_world", None)
    if world is None or world.rank != 0:
        return
    try:
        profile2mat(path)
        profile2mat(f"{path}_filtered")
    except (OSError, ValueError):
        pass


def profile2mat(prefix: str) -> Dict[str, List[List[float]]]:
    """test/monitoring/profile2mat.pl analog: glob {prefix}.*.prof,
    parse 'src dst msgs bytes' lines, and write three N x N
    space-separated matrices — {prefix}_msg.mat (message counts),
    {prefix}_size.mat (byte totals), {prefix}_avg.mat (bytes/msg).
    Returns the matrices for tests."""
    import glob as _glob

    entries: List[tuple] = []
    nmax = -1
    for fname in sorted(_glob.glob(f"{prefix}.*.prof")):
        with open(fname) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) != 4:
                    continue
                src, dst, msgs, nbytes = (int(parts[0]), int(parts[1]),
                                          int(parts[2]), int(parts[3]))
                entries.append((src, dst, msgs, nbytes))
                nmax = max(nmax, src, dst)
    n = nmax + 1
    msg = [[0] * n for _ in range(n)]
    size = [[0] * n for _ in range(n)]
    for src, dst, msgs, nbytes in entries:
        msg[src][dst] += msgs
        size[src][dst] += nbytes
    avg = [[(size[i][j] / msg[i][j] if msg[i][j] else 0.0)
            for j in range(n)] for i in range(n)]
    for suffix, mat in (("_msg", msg), ("_size", size), ("_avg", avg)):
        with open(f"{prefix}{suffix}.mat", "w") as fh:
            for row in mat:
                fh.write(" ".join(f"{v:g}" for v in row) + "\n")
    return {"msg": msg, "size": size, "avg": avg}
