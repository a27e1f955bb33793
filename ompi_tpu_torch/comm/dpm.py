"""Dynamic process management: spawn / connect / accept / ports.

Re-design of ompi/dpm (ref: ompi/dpm/dpm.c — connect_accept builds
the bridge and calls add_procs; spawn goes through the runtime's
PMIx server).  Here the launcher's KV server is the universe
authority: it allocates universe-rank blocks for spawned jobs and
carries the port rendezvous records; mpirun drains spawn requests and
fork/execs the new job with TPUMPI_WORLD_BASE/TPUMPI_UNIVERSE env
identity (tools/mpirun.py).

The cross-job handshake needs p2p before any shared communicator
exists, so leaders meet on a **bridge**: a comm-shaped shim whose cid
is derived from the accept/spawn record (universe-unique, negative so
it can never collide with agreed cids) and whose 2-entry group is
[side-A leader, side-B leader].  intercomm_create() then runs its
normal leader exchange + bridged CID agreement over that bridge.
"""

from __future__ import annotations

import uuid
from typing import List, Optional

from .communicator import Communicator, Group
from .intercomm import Intercommunicator, intercomm_create

# bridge cids live far below user/agreed cids and are derived from
# universe-unique integers (a spawn's rank base; an accept's sequence)
_SPAWN_CID_BASE = -1_000_000
_PORT_CID_BASE = -2_000_000


class _BridgeComm:
    """Comm-shaped shim for leader-to-leader p2p before a real
    communicator exists.  group = [leaderA_global, leaderB_global];
    my rank is my index in it."""

    def __init__(self, state, cid: int, leaders: List[int]) -> None:
        self.state = state
        self.cid = cid
        self.group = list(leaders)
        self.rank = self.group.index(state.rank)
        self.size = len(self.group)

    def _bridge_peer(self) -> int:
        return 1 - self.rank


def _kv(state):
    kv = getattr(state.rte, "kv", None)
    if kv is None:
        raise RuntimeError(
            "dynamic process management needs the launcher's KV "
            "server (run under mpirun)")
    return kv


# ---------------------------------------------------------------------
# ports + name service (ref: ompi/mpi/c/open_port.c, publish_name.c)
# ---------------------------------------------------------------------

def open_port(state) -> str:
    return f"tpumpi-port-{state.rank}-{uuid.uuid4().hex[:12]}"


def publish_name(state, service: str, port: str) -> None:
    _kv(state).put(f"svc:{service}", port)


def lookup_name(state, service: str) -> str:
    return _kv(state).get(f"svc:{service}")


def unpublish_name(state, service: str) -> None:
    _kv(state).put(f"svc:{service}", None)


# ---------------------------------------------------------------------
# connect / accept (ref: dpm.c ompi_dpm_connect_accept)
# ---------------------------------------------------------------------

def comm_accept(comm: Communicator, port: str, root: int = 0
                ) -> Intercommunicator:
    """Collective over `comm`; the root posts the accept record and
    waits for a connector."""
    state = comm.state
    import numpy as np
    meta = np.empty(2, dtype=np.int64)
    if comm.rank == root:
        kv = _kv(state)
        # pair acceptor i with connector i on this port (sequence
        # counters), and draw the bridge cid from a universe-global
        # counter so concurrent handshakes can never collide
        aseq = kv.incr(f"port:{port}:aseq")
        cid = _PORT_CID_BASE - kv.incr("dpm:bridge_cid")
        kv.put(f"port:{port}:accept:{aseq}",
               {"leader": state.rank, "cid": cid})
        try:
            peer = kv.take(f"port:{port}:connect:{aseq}", timeout=300.0)
        except TimeoutError:
            # No connector: withdraw the offer so the port counters
            # stay in sync for later pairs.  If the record is already
            # gone a connector consumed it while we timed out — the
            # rendezvous actually succeeded, so finish it.
            try:
                kv.take(f"port:{port}:accept:{aseq}", timeout=0.05)
                withdrawn = True
            except TimeoutError:
                withdrawn = False
            if withdrawn:
                kv.uncr(f"port:{port}:aseq", aseq)
                raise
            peer = kv.take(f"port:{port}:connect:{aseq}", timeout=30.0)
        meta[0] = cid
        meta[1] = peer["leader"]
    comm.Bcast(meta, root=root)
    cid, remote_leader = int(meta[0]), int(meta[1])
    return _bridged_create(comm, root, cid, remote_leader,
                           accept_side=True)


def comm_connect(comm: Communicator, port: str, root: int = 0
                 ) -> Intercommunicator:
    state = comm.state
    import numpy as np
    meta = np.empty(2, dtype=np.int64)
    if comm.rank == root:
        kv = _kv(state)
        cseq = kv.incr(f"port:{port}:cseq")
        try:
            acc = kv.take(f"port:{port}:accept:{cseq}", timeout=300.0)
        except TimeoutError:
            # No acceptor: return the ticket so the next well-matched
            # pair on this port still lines up (counter-desync guard)
            kv.uncr(f"port:{port}:cseq", cseq)
            raise
        kv.put(f"port:{port}:connect:{cseq}", {"leader": state.rank})
        meta[0] = acc["cid"]
        meta[1] = acc["leader"]
    comm.Bcast(meta, root=root)
    cid, remote_leader = int(meta[0]), int(meta[1])
    return _bridged_create(comm, root, cid, remote_leader,
                           accept_side=False)


def _bridged_create(comm: Communicator, root: int, bridge_cid: int,
                    remote_leader: int, accept_side: bool
                    ) -> Intercommunicator:
    """Common tail: make dynamic peers addressable, build the bridge,
    run the intercomm creation handshake over it."""
    from ompi_tpu_torch.runtime.init import extend_universe

    state = comm.state
    # make the remote LEADER addressable first (the handshake is
    # leader-to-leader); the full remote group is learned during
    # creation and covered right after
    extend_universe(state, remote_leader + 1)
    if comm.rank == root:
        leaders = ([state.rank, remote_leader] if accept_side
                   else [remote_leader, state.rank])
        bridge = _BridgeComm(state, bridge_cid, leaders)
        inter = intercomm_create(comm, root, bridge,
                                 bridge._bridge_peer(), tag=0)
    else:
        inter = intercomm_create(comm, root, None, 0, tag=0)
    # now every remote member is known: cover the whole remote group
    extend_universe(state, max(inter.group) + 1)
    return inter


# ---------------------------------------------------------------------
# spawn (ref: dpm.c ompi_dpm_spawn + MPI_Comm_spawn)
# ---------------------------------------------------------------------

def comm_spawn(comm: Communicator, cmd: str, args: List[str],
               maxprocs: int, root: int = 0) -> Intercommunicator:
    """Collective over `comm`: launch `maxprocs` new universe ranks
    running `cmd` and return the parent-side intercomm."""
    return comm_spawn_multiple(
        comm, [(cmd, list(args), maxprocs)], root)


def comm_spawn_multiple(comm: Communicator, specs, root: int = 0
                        ) -> Intercommunicator:
    """MPI_Comm_spawn_multiple: specs = [(cmd, args, maxprocs), ...],
    all children in ONE world (per-segment MPI_APPNUM set)."""
    from ompi_tpu_torch.runtime.init import extend_universe

    state = comm.state
    import numpy as np
    maxprocs = sum(int(n) for _c, _a, n in specs)
    meta = np.empty(1, dtype=np.int64)
    if comm.rank == root:
        base = _kv(state).spawn_multiple(
            [{"cmd": c, "args": list(a), "n": int(n)}
             for c, a, n in specs], state.rank)
        meta[0] = base
    comm.Bcast(meta, root=root)
    base = int(meta[0])
    extend_universe(state, base + maxprocs)
    bridge_cid = _SPAWN_CID_BASE - base
    if comm.rank == root:
        bridge = _BridgeComm(state, bridge_cid, [state.rank, base])
        return intercomm_create(comm, root, bridge, 1, tag=0)
    return intercomm_create(comm, root, None, 1, tag=0)


def get_parent(comm_world: Communicator) -> Optional[Intercommunicator]:
    """MPI_Comm_get_parent analog: in a spawned job, the intercomm to
    the spawning communicator (collective over comm_world on first
    call)."""
    state = comm_world.state
    parent_root = getattr(state.rte, "parent_root", None)
    if parent_root is None:
        return None
    cached = state.extra.get("parent_intercomm")
    if cached is not None:
        return cached
    parent_root = int(parent_root)
    base = getattr(state.rte, "world_base", 0)
    bridge_cid = _SPAWN_CID_BASE - base
    if comm_world.rank == 0:
        bridge = _BridgeComm(state, bridge_cid,
                             [parent_root, state.rank])
        inter = intercomm_create(comm_world, 0, bridge, 0, tag=0)
    else:
        inter = intercomm_create(comm_world, 0, None, 0, tag=0)
    state.extra["parent_intercomm"] = inter
    return inter


# ---------------------------------------------------------------------
# join (ref: ompi/mpi/c/comm_join.c — two processes holding the ends
# of a connected socket build a 1-1 intercommunicator by exchanging
# port names over the fd, then running connect/accept)
# ---------------------------------------------------------------------

def comm_join(comm_self: Communicator, fd: int) -> Intercommunicator:
    """MPI_Comm_join: ``fd`` is a connected, bidirectional socket
    shared with exactly one peer process of the same universe.  Each
    side opens a port and sends it over the fd; the side with the
    lexicographically smaller port string accepts on its own port,
    the other connects to the received one (the reference decides
    send_first by the same kind of total order)."""
    import os
    import struct as _struct

    state = comm_self.state
    my_port = open_port(state)

    def _write_all(data: bytes) -> None:
        off = 0
        while off < len(data):
            off += os.write(fd, data[off:])

    def _read_exact(n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = os.read(fd, n - len(out))
            if not chunk:
                raise ConnectionError(
                    "MPI_Comm_join: peer closed the socket during "
                    "the port exchange")
            out += chunk
        return out

    enc = my_port.encode()
    _write_all(_struct.pack(">I", len(enc)) + enc)
    (n,) = _struct.unpack(">I", _read_exact(4))
    peer_port = _read_exact(n).decode()
    if my_port == peer_port:
        raise ValueError("MPI_Comm_join: both ends exchanged the "
                         "same port name (fd looped back to self?)")
    if my_port < peer_port:
        return comm_accept(comm_self, my_port, root=0)
    return comm_connect(comm_self, peer_port, root=0)
