"""Intercommunicators: two disjoint groups bridged for p2p and
two-group collectives.

Re-design of the reference's intercomm paths
(ref: ompi/communicator/comm.c:1100+ ompi_intercomm_create;
ompi/mpi/c/intercomm_create.c / intercomm_merge.c; coll/inter
semantics in ompi/mca/coll/inter).

Data model: an Intercommunicator carries BOTH groups.  ``rank`` and
``size`` refer to the LOCAL group (MPI_Comm_rank/size semantics);
p2p destination/source indices address the REMOTE group — which is
exactly what the pml's ``comm.group[dst]`` translation needs, so the
``group`` property exposes the remote ranks and the matching engine
works unchanged (the sender's local rank IS the receiver's remote
index, because each side's remote group is the other's local group in
the same order).

Construction runs the reference's two-level agreement: group lists
exchanged leader-to-leader over a bridge, broadcast locally, then a
CID agreed over the UNION by iterating (local max-allreduce ->
leader exchange -> local bcast) until the cid is free on every member
of both groups (the comm_cid.c multi-round idea stretched over the
bridge).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .communicator import Communicator, Group, TAG_CID, _cid_proposal

# MPI_ROOT sentinel for rooted intercomm collectives (the root-group
# rank that sources/sinks the data passes ROOT; its peers PROC_NULL)
ROOT = -4

TAG_IBRIDGE = -26
TAG_IMERGE = -27
TAG_ISPLIT = -28


def _icreate_wire_tag(tag: int) -> int:
    """Fold the user's intercomm_create tag into the dedicated
    [-1500, -1999] block so it can never land on another internal
    protocol's tag (small negatives, create_group's [-400,-1399],
    nbc's <=-2000) or in non-negative user tag space.  Like
    create_group's fold, CONCURRENT creations between the same leader
    pair with tags 500 apart would alias — the (peer_comm, tag) pair
    disambiguates real uses; sequential creations are always safe
    (matching is ordered per (cid, src, tag))."""
    return -1500 - (tag % 500)


class Intercommunicator(Communicator):
    def __init__(self, state, cid: int, local_group: Group,
                 remote_group: Group, local_comm: Communicator,
                 name: str = "") -> None:
        self._remote_group = remote_group
        # base ctor computes rank/size from the LOCAL group and stacks
        # the coll modules (comm_select special-cases intercomms)
        super().__init__(state, cid, local_group,
                         name or f"intercomm-{cid}")
        self.local_comm = local_comm  # private dup for local phases

    # -- identity ------------------------------------------------------
    @property
    def is_inter(self) -> bool:
        return True

    @property
    def group(self) -> List[int]:
        """p2p rank translation table = the REMOTE group."""
        return self._remote_group.ranks

    def local_group_obj(self) -> Group:
        return Group(self._group.ranks)

    def remote_group_obj(self) -> Group:
        return Group(self._remote_group.ranks)

    @property
    def remote_size(self) -> int:
        return self._remote_group.size

    # -- capabilities ---------------------------------------------------
    def mesh(self):
        return None  # never device-offloadable as one mesh

    def split(self, color: int, key: int = 0):
        """MPI_Comm_split on an intercommunicator (ref:
        ompi/mpi/c/comm_split.c -> ompi_comm_split inter branch):
        members of the SAME color on both sides form a new
        intercommunicator; a color with members on only one side gets
        MPI_COMM_NULL (None), per MPI-3.1 §6.4.2.

        Both sides order each color group by (key, old local rank),
        computed identically from the exchanged (color, key) tables.
        """
        from .communicator import UNDEFINED
        _init_dt()
        lc = self.local_comm
        pml = self._pml()

        # 1. allgather (color, key) within each local group, in old
        # local-rank order
        mine = np.array([color, key], dtype=np.int64)
        local_tbl = np.empty((lc.size, 2), dtype=np.int64)
        lc.Allgather(mine, local_tbl)

        # 2. leaders exchange the full tables across the bridge
        # (local rank 0 <-> remote rank 0 over the intercomm), then
        # bcast locally
        if lc.rank == 0:
            sreq = pml.isend(local_tbl, local_tbl.size, _I64, 0,
                             TAG_ISPLIT, self)
            remote_tbl = np.empty((self.remote_size, 2),
                                  dtype=np.int64)
            pml.recv(remote_tbl, remote_tbl.size, _I64, 0,
                     TAG_ISPLIT, self)
            sreq.wait()
        else:
            remote_tbl = np.empty((self.remote_size, 2),
                                  dtype=np.int64)
        lc.Bcast(remote_tbl, root=0)

        # 3. my color's ordered subgroups on both sides (global ranks)
        def members(tbl, group):
            out = [(int(tbl[i][1]), i, group[i])
                   for i in range(len(group))
                   if int(tbl[i][0]) == color]
            out.sort()
            return [g for (_k, _i, g) in out]

        # 4. split the private local comm (handles UNDEFINED and the
        # local cid agreement); every member of the old intercomm
        # participates (comm_split is collective over both groups)
        local_split = lc.split(color, key)
        if color == UNDEFINED or local_split is None:
            return None
        my_local = members(local_tbl, self._group.ranks)
        my_remote = members(remote_tbl, self._remote_group.ranks)
        if not my_remote:
            # my color exists only on this side -> MPI_COMM_NULL
            local_split.free()
            return None

        # 5. cid agreement between the two color groups: the color
        # leaders bridge over the OLD intercomm (distinct leader
        # pairs per color -> per-(src) matching keeps them apart)
        am_leader = my_local[0] == self.state.rank
        if am_leader:
            # remote color leader's index in the old REMOTE group
            r_leader = self._remote_group.ranks.index(my_remote[0])
            bridge = _SplitBridge(self, r_leader)
            cid = _bridge_cid_agree_leader(self.state, local_split,
                                           bridge, 0)
        else:
            cid = _bridge_cid_agree_leader(self.state, local_split,
                                           None, 0)
        out = Intercommunicator(self.state, cid, Group(my_local),
                                Group(my_remote), local_split,
                                name=f"{self.name}-split")
        out.errhandler = self.errhandler  # MPI: children inherit
        return out

    def free(self) -> None:
        self.local_comm.free()
        super().free()

    # -- merge ----------------------------------------------------------
    def merge(self, high: bool = False) -> Communicator:
        """MPI_Intercomm_merge (ref: intercomm_merge.c): one intracomm
        over the union; the 'low' group's ranks come first.  Ties on
        `high` break by smallest global rank so both sides compute the
        same order."""
        lc = self.local_comm
        # leaders exchange (high, min_global_rank)
        mine = np.array([1 if high else 0, min(self._group.ranks)],
                        dtype=np.int64)
        if lc.rank == 0:
            sreq = self._pml().isend(mine, 2, _I64, 0, TAG_IMERGE, self)
            theirs = np.empty(2, dtype=np.int64)
            self._pml().recv(theirs, 2, _I64, 0, TAG_IMERGE, self)
            sreq.wait()
        else:
            theirs = np.empty(2, dtype=np.int64)
        lc.Bcast(theirs, root=0)
        r_high, r_min = int(theirs[0]), int(theirs[1])
        my_high = 1 if high else 0
        if my_high != r_high:
            we_low = my_high == 0
        else:
            we_low = min(self._group.ranks) < r_min
        merged = (self._group.ranks + self._remote_group.ranks
                  if we_low else
                  self._remote_group.ranks + self._group.ranks)
        cid = _bridge_cid_agree_leader(
            self.state, lc, self if lc.rank == 0 else None, 0)
        out = Communicator(self.state, cid, Group(merged),
                           name=f"{self.name}-merged")
        out.errhandler = self.errhandler  # MPI: children inherit
        return out


_I64 = None


def _init_dt():
    global _I64
    if _I64 is None:
        from ompi_tpu_torch.datatype import engine as dtmod
        _I64 = dtmod.INT64_T
    return _I64


class _SplitBridge:
    """Adapter bridging a color-group leader to its remote color
    leader over the OLD intercomm during intercomm split."""

    def __init__(self, inter: "Intercommunicator",
                 remote_leader: int) -> None:
        self.inter = inter
        self.remote_leader = remote_leader

    def _bridge_peer(self) -> int:
        return self.remote_leader

    def __getattr__(self, name):
        return getattr(self.inter, name)


class _PeerBridge:
    """Adapter giving _bridge_cid_agree a rank-0-to-remote-leader
    path over the peer communicator during intercomm creation."""

    def __init__(self, peer_comm: Communicator, remote_leader: int) -> None:
        self.peer_comm = peer_comm
        self.remote_leader = remote_leader
        self.cid = peer_comm.cid
        self.state = peer_comm.state

    def _bridge_peer(self) -> int:
        return self.remote_leader

    # quacks like a communicator for the pml (cid + group translation)
    @property
    def group(self):
        return self.peer_comm.group

    def __getattr__(self, name):
        return getattr(self.peer_comm, name)


def intercomm_create(local_comm: Communicator, local_leader: int,
                     peer_comm: Optional[Communicator],
                     remote_leader: int, tag: int = 0
                     ) -> Intercommunicator:
    """MPI_Intercomm_create (ref: comm.c:1100+): collective over both
    local comms; the two leaders must share ``peer_comm``."""
    _init_dt()
    state = local_comm.state
    am_leader = local_comm.rank == local_leader
    wire_tag = _icreate_wire_tag(tag)
    if am_leader and peer_comm is None:
        raise ValueError("leader needs a peer communicator")
    pml = state.pml

    # 1. leaders exchange local group rank lists over the peer comm
    if am_leader:
        mine = np.asarray(local_comm.group_obj().ranks, dtype=np.int64)
        szs = np.array([mine.size], dtype=np.int64)
        s1 = pml.isend(szs, 1, _I64, remote_leader, wire_tag,
                       peer_comm)
        their_n = np.empty(1, dtype=np.int64)
        pml.recv(their_n, 1, _I64, remote_leader, wire_tag,
                 peer_comm)
        s1.wait()
        s2 = pml.isend(mine, mine.size, _I64, remote_leader,
                       wire_tag, peer_comm)
        theirs = np.empty(int(their_n[0]), dtype=np.int64)
        pml.recv(theirs, theirs.size, _I64, remote_leader,
                 wire_tag, peer_comm)
        s2.wait()
        meta = np.array([theirs.size], dtype=np.int64)
    else:
        meta = np.empty(1, dtype=np.int64)
        theirs = None

    # 2. broadcast the remote group within the local comm
    # (root must be the local leader, who owns the data)
    local_comm.Bcast(meta, root=local_leader)
    if theirs is None:
        theirs = np.empty(int(meta[0]), dtype=np.int64)
    local_comm.Bcast(theirs, root=local_leader)
    remote_group = Group([int(x) for x in theirs])

    if set(remote_group.ranks) & set(local_comm.group_obj().ranks):
        raise ValueError("intercomm groups must be disjoint")

    # 3. cid agreement over the union, bridged leader-to-leader.
    # The bridge rides the peer comm, so run it through an adapter;
    # non-leaders only see the local phases.
    lc = local_comm.dup(name="intercomm-local")
    if am_leader:
        bridge = _PeerBridge(peer_comm, remote_leader)
        cid = _bridge_cid_agree_leader(state, local_comm, bridge,
                                       local_leader)
    else:
        cid = _bridge_cid_agree_leader(state, local_comm, None,
                                       local_leader)
    inter = Intercommunicator(state, cid, local_comm.group_obj(),
                              remote_group, lc)
    inter.errhandler = local_comm.errhandler  # MPI: children inherit
    return inter


def _bridge_cid_agree_leader(state, local_comm: Communicator,
                             bridge: Optional[_PeerBridge],
                             local_leader: int) -> int:
    """CID agreement where only ``local_leader`` talks across the
    bridge (creation-time variant of _bridge_cid_agree, which assumes
    leader == local rank 0)."""
    _init_dt()
    pml = state.pml
    while True:
        proposal = _cid_proposal(state)
        agreed = local_comm._allreduce_max_int(proposal, TAG_CID)
        buf = np.array([agreed], dtype=np.int64)
        if bridge is not None:
            sreq = pml.isend(buf, 1, _I64, bridge._bridge_peer(),
                             TAG_IBRIDGE, bridge)
            theirs = np.empty(1, dtype=np.int64)
            pml.recv(theirs, 1, _I64, bridge._bridge_peer(),
                     TAG_IBRIDGE, bridge)
            sreq.wait()
            buf[0] = max(agreed, int(theirs[0]))
        local_comm.Bcast(buf, root=local_leader)
        agreed = int(buf[0])
        ok = 1 if agreed not in state.comms else 0
        all_ok = -local_comm._allreduce_max_int(-ok, TAG_CID)
        buf[0] = all_ok
        if bridge is not None:
            sreq = pml.isend(buf, 1, _I64, bridge._bridge_peer(),
                             TAG_IBRIDGE, bridge)
            theirs = np.empty(1, dtype=np.int64)
            pml.recv(theirs, 1, _I64, bridge._bridge_peer(),
                     TAG_IBRIDGE, bridge)
            sreq.wait()
            buf[0] = min(all_ok, int(theirs[0]))
        local_comm.Bcast(buf, root=local_leader)
        if int(buf[0]) == 1:
            return agreed
        state.comms.setdefault(agreed, None)


# give Intercommunicator._bridge_peer for the merge-time bridge (the
# intercomm itself: remote leader is remote rank 0)
def _intercomm_bridge_peer(self) -> int:
    return 0


Intercommunicator._bridge_peer = _intercomm_bridge_peer
