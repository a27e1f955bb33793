"""Groups and communicators: the substrate of every parallelism axis.

Re-design of ompi/communicator (ref: comm.c:406 ompi_comm_split,
split_type :650-749; comm_cid.c:47-86 — CID allocation as an
agreement over the parent communicator; ompi/group dense groups).

A communicator is (cid, ordered list of global ranks, my position).
CID agreement runs as a max-allreduce of each member's smallest free
cid over the *parent* communicator using reserved internal tags,
repeated until the agreed cid is free everywhere — the same
multi-round idea as the reference, built on p2p so it works before
any collective module exists.

Device mapping: a communicator whose member ranks all share one card
is served by coll/hbm (coll/device.py); one whose members own
pairwise-distinct devices — cards, or logical devices of one card — by
the mesh tier, coll/tpu (``Communicator.mesh``).  A communicator whose
members partly share devices is refused by both.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ompi_tpu_torch.datatype import engine as dtmod
from ompi_tpu_torch.pml.request import ANY_TAG, PROC_NULL, Status

# internal tags (user tags must be >= 0)
TAG_CID = -17
TAG_SPLIT = -18
TAG_BCAST = -19
TAG_GATHER = -20

UNDEFINED = -32766

COMM_TYPE_SHARED = 1

class Group:
    """Dense ordered set of global ranks (ref: ompi/group)."""

    def __init__(self, ranks: Sequence[int]) -> None:
        self.ranks = list(ranks)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def rank_of(self, global_rank: int) -> int:
        try:
            return self.ranks.index(global_rank)
        except ValueError:
            return UNDEFINED

    def translate(self, other: "Group", rank: int) -> int:
        return other.rank_of(self.ranks[rank])

    def incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.ranks[r] for r in ranks])

    def excl(self, ranks: Sequence[int]) -> "Group":
        drop = set(ranks)
        return Group([g for i, g in enumerate(self.ranks) if i not in drop])

    def union(self, other: "Group") -> "Group":
        out = list(self.ranks)
        out += [r for r in other.ranks if r not in set(self.ranks)]
        return Group(out)

    def intersection(self, other: "Group") -> "Group":
        oset = set(other.ranks)
        return Group([r for r in self.ranks if r in oset])

    def difference(self, other: "Group") -> "Group":
        oset = set(other.ranks)
        return Group([r for r in self.ranks if r not in oset])


class Communicator:
    # per-comm monotone span-correlation counters (ompi_tpu_torch/trace).
    # Class-level defaults so the hot paths read/write them as plain
    # attributes — no dict.get() call
    _coll_seq = 0
    _dev_seq = 0

    def __init__(self, state, cid: int, group: Group, name: str = "") -> None:
        self.state = state
        self.cid = cid
        self._group = group
        self.name = name or f"comm-{cid}"
        self.rank = group.rank_of(state.rank)
        self.size = group.size
        self.coll: Any = None       # collective module stack (coll framework)
        self.topo = None            # process topology (ompi_tpu_torch.topo)
        state.comms[cid] = self
        # stack collective modules (coll_base_comm_select analog);
        # local-only, so safe even mid-split on a subset of ranks
        from ompi_tpu_torch.coll import framework as _coll_fw
        _coll_fw.comm_select(self)

    # group is exposed as the raw rank list for hot-path translation
    @property
    def group(self) -> List[int]:
        return self._group.ranks

    def group_obj(self) -> Group:
        return Group(self._group.ranks)

    # -- p2p shorthands used by comm management + coll/base --------------
    def _pml(self):
        return self.state.pml

    def psend(self, obj: Any, dst: int, tag: int) -> None:
        """Internal typed-object send (numpy int64 vectors)."""
        arr = np.atleast_1d(np.asarray(obj, dtype=np.int64))
        self._pml().send(arr, arr.size, dtmod.INT64_T, dst, tag, self)

    def precv(self, n: int, src: int, tag: int) -> np.ndarray:
        arr = np.empty(n, dtype=np.int64)
        self._pml().recv(arr, n, dtmod.INT64_T, src, tag, self)
        return arr

    # -- cid agreement ---------------------------------------------------
    def _allreduce_max_int(self, value: int, tag: int) -> int:
        """Recursive-doubling-free simple max: gather to comm rank 0,
        bcast back (used only for management traffic)."""
        if self.size == 1:
            return value
        if self.rank == 0:
            best = value
            for r in range(1, self.size):
                best = max(best, int(self.precv(1, r, tag)[0]))
            for r in range(1, self.size):
                self.psend(best, r, tag)
            return best
        self.psend(value, 0, tag)
        return int(self.precv(1, 0, tag)[0])

    def next_cid(self) -> int:
        """Agree on a cid free on every member of *this* comm
        (ref: ompi_comm_nextcid multi-round agreement)."""
        while True:
            proposal = self.state.next_cid_local()
            agreed = self._allreduce_max_int(proposal, TAG_CID)
            ok = 1 if agreed not in self.state.comms else 0
            all_ok = self._allreduce_max_int(-ok, TAG_CID)  # max(-ok)=0 iff any not ok
            if all_ok == -1:
                return agreed
            # else: someone had it taken; reserve and retry
            self.state.comms.setdefault(agreed, None)

    # -- management operations ------------------------------------------
    def dup(self, name: str = "") -> "Communicator":
        cid = self.next_cid()
        new = Communicator(self.state, cid, Group(self.group),
                           name or f"{self.name}-dup")
        new.topo = self.topo  # MPI_Comm_dup carries the topology over
        return new

    def create_group(self, group: Group, tag: int = 0
                     ) -> Optional["Communicator"]:
        """MPI_Comm_create_group (ref: ompi/mpi/c/comm_create_group.c):
        collective only over `group`'s members — the agreement rides a
        shim translating group ranks over the parent's cid with a
        dedicated tag, so non-members never participate."""
        my_pos = group.rank_of(self.state.rank)
        if my_pos == UNDEFINED:
            return None

        parent = self
        grp_ranks = list(group.ranks)

        class _GroupShim:
            """Comm-shaped view of `group` over the parent's cid."""
            cid = parent.cid
            state = parent.state
            size = len(grp_ranks)
            rank = my_pos
            group = grp_ranks  # the p2p translation table

            psend = Communicator.psend
            precv = Communicator.precv
            _pml = Communicator._pml
            _allreduce_max_int = Communicator._allreduce_max_int

        shim = _GroupShim()
        # multi-round agreement among group members only; the wire tag
        # lives in a dedicated [-400, -1399] block so no user tag can
        # land it on another internal protocol's tag (concurrent
        # create_group calls with tags 1000 apart would collide — the
        # comm/tag pair disambiguates real uses)
        wire_tag = -400 - (tag % 1000)
        while True:
            proposal = self.state.next_cid_local()
            agreed = shim._allreduce_max_int(proposal, wire_tag)
            ok = 1 if agreed not in self.state.comms else 0
            all_ok = shim._allreduce_max_int(-ok, wire_tag)
            if all_ok == -1:
                return Communicator(self.state, agreed, group)
            self.state.comms.setdefault(agreed, None)

    def create(self, group: Group) -> Optional["Communicator"]:
        """MPI_Comm_create: collective over the parent; ranks outside
        `group` get None (MPI_COMM_NULL)."""
        cid = self.next_cid()
        if group.rank_of(self.state.rank) == UNDEFINED:
            self.state.comms.setdefault(cid, None)  # keep cid reserved
            return None
        return Communicator(self.state, cid, group)

    def split(self, color: int, key: int = 0) -> Optional["Communicator"]:
        """MPI_Comm_split (ref: comm.c:406): gather (color,key) on
        rank 0, compute ordered subgroups, scatter memberships, then a
        single parent-wide cid round per resulting group."""
        me = [color, key, self.state.rank]
        if self.rank == 0:
            table = [me] + [list(self.precv(3, r, TAG_SPLIT))
                            for r in range(1, self.size)]
            groups: Dict[int, List] = {}
            for i, (c, k, g) in enumerate(table):
                if c == UNDEFINED:
                    continue
                groups.setdefault(c, []).append((k, i, g))
            for c in groups:
                groups[c].sort()
            # send each rank its group's global-rank list (or empty);
            # fixed-size messages: [n, pad...] then payload
            mine: List[int] = []
            for r in range(self.size):
                c = table[r][0]
                payload = [] if c == UNDEFINED else \
                    [g for (_, _, g) in groups[c]]
                if r == 0:
                    mine = payload
                else:
                    self.psend([len(payload)], r, TAG_SPLIT)
                    if payload:
                        self.psend(payload, r, TAG_SPLIT)
        else:
            self.psend(me, 0, TAG_SPLIT)
            n = int(self.precv(1, 0, TAG_SPLIT)[0])
            mine = [int(x) for x in self.precv(n, 0, TAG_SPLIT)] if n else []
        # every parent rank participates in ONE cid agreement so the
        # cid is globally fresh even across disjoint split groups
        cid = self.next_cid()
        if not mine:
            self.state.comms.setdefault(cid, None)
            return None
        return Communicator(self.state, cid, Group(mine))

    def split_type(self, split_type: int, key: int = 0
                   ) -> Optional["Communicator"]:
        """MPI_Comm_split_type (ref: comm.c:650-749).  Every
        thread-rank shares the node, so SHARED groups all co-located
        ranks (locality via the rte)."""
        node = getattr(self.state.rte, "node_id", 0)
        if split_type == COMM_TYPE_SHARED:
            return self.split(node, key)
        return self.split(UNDEFINED, key)

    def free(self) -> None:
        self.state.comms.pop(self.cid, None)
        # keep the cid burned so in-flight traffic can't alias it
        self.state.comms.setdefault(self.cid, None)
        # drop this comm's device-collective rendezvous (one entry per
        # (cid, group) in the world's shared dict)
        world = getattr(self.state.rte, "world", None)
        if world is not None:
            with world.shared_lock:
                world.shared.pop(("coll_rv", self.cid, tuple(self.group)),
                                 None)

    # -- device mesh mapping -------------------------------------------
    def mesh(self):
        """The members' devices in rank order (a tuple of
        torch.device), or None when members do not own pairwise-
        distinct devices (then coll/tpu is not eligible).  Distinct by
        ``runtime.init.device_key``: logical devices of one card are
        distinct.  Both verdicts are cached: device ownership is fixed
        for a comm's members."""
        m = self.__dict__.get("_mesh")
        if m is not None:
            return m
        if self.__dict__.get("_mesh_none"):
            return None
        from ompi_tpu_torch.runtime.init import device_key
        devs, keys = [], set()
        for g in self.group:
            st = self._peer_state(g)
            if st is None or st.device is None:
                self.__dict__["_mesh_none"] = True
                return None
            devs.append(st.device)
            keys.add(device_key(st))
        if len(keys) != len(devs):
            self.__dict__["_mesh_none"] = True
            return None
        m = self.__dict__["_mesh"] = tuple(devs)
        return m

    def _peer_state(self, global_rank: int):
        world = getattr(self.state.rte, "world", None)
        if world is None:
            return self.state if global_rank == self.state.rank else None
        return world.states[global_rank]

    def abort(self, errorcode: int = 1) -> None:
        self.state.rte.abort(errorcode, f"abort on {self.name}")

    # ------------------------------------------------------------------
    # Public MPI API (mpi4py-flavored buffer methods).  Buffer specs:
    # a numpy array (count/datatype inferred), or (buf, datatype), or
    # (buf, count, datatype).  Mirrors the C surface (ref:
    # ompi/mpi/c/*.c) at Python altitude, as far as the port reaches.
    # ------------------------------------------------------------------

    @staticmethod
    def _spec(spec):
        from ompi_tpu_torch.coll.buffers import IN_PLACE
        if spec is IN_PLACE:
            return IN_PLACE, 0, None
        if isinstance(spec, tuple):
            if len(spec) == 3:
                return spec
            if len(spec) == 2:
                buf, dt = spec
                n = np.asarray(buf).nbytes // dt.size if dt.size else 0
                return buf, n, dt
        arr = spec
        dt = dtmod.from_numpy_dtype(arr.dtype)
        return arr, arr.size, dt

    @staticmethod
    def _check_tag(tag: int, recv: bool = False) -> None:
        """User tags must be >= 0 (negative space is reserved for comm
        management/collective traffic); ANY_TAG legal on receives."""
        if tag < 0 and not (recv and tag == -1):
            raise ValueError(
                f"invalid tag {tag}: user tags must be >= 0 (MPI_ERR_TAG)")

    # -- p2p ------------------------------------------------------------
    def Send(self, spec, dest: int, tag: int = 0) -> None:
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        self.state.pml.send(buf, count, dt, dest, tag, self)

    def Ssend(self, spec, dest: int, tag: int = 0) -> None:
        from ompi_tpu_torch.pml.ob1 import MODE_SYNC
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        self.state.pml.send(buf, count, dt, dest, tag, self, MODE_SYNC)

    def Recv(self, spec, source: int = -1, tag: int = -1) -> Status:
        self._check_tag(tag, recv=True)
        buf, count, dt = self._spec(spec)
        return self.state.pml.recv(buf, count, dt, source, tag, self)

    def Isend(self, spec, dest: int, tag: int = 0):
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        return self.state.pml.isend(buf, count, dt, dest, tag, self)

    def Issend(self, spec, dest: int, tag: int = 0):
        from ompi_tpu_torch.pml.ob1 import MODE_SYNC
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        return self.state.pml.isend(buf, count, dt, dest, tag, self,
                                    MODE_SYNC)

    def Irecv(self, spec, source: int = -1, tag: int = -1):
        self._check_tag(tag, recv=True)
        buf, count, dt = self._spec(spec)
        return self.state.pml.irecv(buf, count, dt, source, tag, self)

    # -- ready sends (ref: ompi/mpi/c/rsend.c) ---------------------------
    # a ready send is correct whenever a standard send is; the
    # reference's rsend is likewise standard-send under ob1.  This
    # silently legalizes erroneous programs (no matching-recv check),
    # so the behavior is declared in the registry
    # (pml_ob1_rsend_is_standard) for ompi_info discoverability.
    def Rsend(self, spec, dest: int, tag: int = 0) -> None:
        self.Send(spec, dest, tag)

    def Irsend(self, spec, dest: int, tag: int = 0):
        return self.Isend(spec, dest, tag)

    def Sendrecv(self, sspec, dest: int, stag: int, rspec, source: int,
                 rtag: int = -1) -> Status:
        rreq = self.Irecv(rspec, source, rtag)
        self.Send(sspec, dest, stag)
        return rreq.wait()

    def Sendrecv_replace(self, spec, dest: int, stag: int, source: int,
                         rtag: int = -1) -> Status:
        """MPI_Sendrecv_replace (ref: ompi/mpi/c/sendrecv_replace.c —
        the send side snapshots the buffer through the convertor
        before the receive overwrites it)."""
        buf, count, dt = self._spec(spec)
        from ompi_tpu_torch.datatype.convertor import Convertor
        snapshot = bytearray(Convertor(dt, count, buf).pack())
        rreq = self.Irecv(spec, source, rtag)
        self.Send((np.frombuffer(snapshot, dtype=np.uint8),
                   count * dt.size if dt.size else 0,
                   dtmod.BYTE), dest, stag)
        return rreq.wait()

    # -- names ----------------------------------------------------------
    def Set_name(self, name: str) -> None:
        self.name = name

    def Get_name(self) -> str:
        return self.name

    def Probe(self, source: int = -1, tag: int = -1) -> Status:
        return self.state.pml.probe(source, tag, self)

    def Iprobe(self, source: int = -1, tag: int = -1) -> Optional[Status]:
        return self.state.pml.iprobe(source, tag, self)

    def Mprobe(self, source: int = -1, tag: int = -1):
        while True:
            m = self.state.pml.improbe(source, tag, self)
            if m is not None:
                return m

    def Mrecv(self, spec, message) -> Status:
        buf, count, dt = self._spec(spec)
        return self.state.pml.mrecv(buf, count, dt, message, self)

    # -- collectives ----------------------------------------------------
    def Barrier(self) -> None:
        self.coll.barrier(self)

    barrier = Barrier

    def Bcast(self, spec, root: int = 0) -> None:
        buf, count, dt = self._spec(spec)
        self.coll.bcast(self, buf, count, dt, root)

    def Reduce(self, sspec, rspec, op, root: int = 0) -> None:
        from ompi_tpu_torch.coll.buffers import IN_PLACE
        sbuf, scount, sdt = self._spec(sspec)
        if rspec is None:
            self.coll.reduce(self, sbuf, None, scount, sdt, op, root)
            return
        rbuf, rcount, rdt = self._spec(rspec)
        if sbuf is IN_PLACE:
            scount, sdt = rcount, rdt
        self.coll.reduce(self, sbuf, rbuf, rcount if rcount else scount,
                         rdt or sdt, op, root)

    def Allreduce(self, sspec, rspec, op) -> None:
        from ompi_tpu_torch.coll.buffers import IN_PLACE
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        self.coll.allreduce(self, sbuf, rbuf, rcount, rdt, op)

    def Allgather(self, sspec, rspec) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        self.coll.allgather(self, sbuf, scount, sdt, rbuf,
                            rcount // self.size, rdt)

    def Allgatherv(self, sspec, rspec, rcounts, displs) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        self.coll.allgatherv(self, sbuf, scount, sdt, rbuf, rcounts,
                             displs, rdt)

    def Gather(self, sspec, rspec, root: int = 0) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        if self.rank == root:
            rbuf, rcount, rdt = self._spec(rspec)
            self.coll.gather(self, sbuf, scount, sdt, rbuf,
                             rcount // self.size, rdt, root)
        else:
            self.coll.gather(self, sbuf, scount, sdt, None, 0, sdt, root)

    def Gatherv(self, sspec, rspec, rcounts, displs, root: int = 0) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        if self.rank == root:
            rbuf, _, rdt = self._spec(rspec)
        else:
            rbuf, rdt = None, sdt
        self.coll.gatherv(self, sbuf, scount, sdt, rbuf, rcounts, displs,
                          rdt, root)

    def Scatter(self, sspec, rspec, root: int = 0) -> None:
        rbuf, rcount, rdt = self._spec(rspec)
        if self.rank == root:
            sbuf, scount, sdt = self._spec(sspec)
            self.coll.scatter(self, sbuf, scount // self.size, sdt, rbuf,
                              rcount, rdt, root)
        else:
            self.coll.scatter(self, None, 0, rdt, rbuf, rcount, rdt, root)

    def Scatterv(self, sspec, scounts, displs, rspec, root: int = 0) -> None:
        rbuf, rcount, rdt = self._spec(rspec)
        if self.rank == root:
            sbuf, _, sdt = self._spec(sspec)
        else:
            sbuf, sdt = None, rdt
        self.coll.scatterv(self, sbuf, scounts, displs, sdt, rbuf, rcount,
                           rdt, root)

    def Alltoall(self, sspec, rspec) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        self.coll.alltoall(self, sbuf, scount // self.size, sdt, rbuf,
                           rcount // self.size, rdt)

    def Alltoallv(self, sspec, scounts, sdispls, rspec, rcounts,
                  rdispls) -> None:
        sbuf, _, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        self.coll.alltoallv(self, sbuf, scounts, sdispls, sdt, rbuf,
                            rcounts, rdispls, rdt)

    def Reduce_scatter(self, sspec, rspec, rcounts, op) -> None:
        sbuf, _, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        self.coll.reduce_scatter(self, sbuf, rbuf, rcounts, rdt, op,
                                 sdtype=sdt)

    def Reduce_scatter_block(self, sspec, rspec, op) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        self.coll.reduce_scatter_block(self, sbuf, rbuf, rcount, rdt, op)

    def Scan(self, sspec, rspec, op) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        self.coll.scan(self, sbuf, rbuf, rcount, rdt, op)

    def Exscan(self, sspec, rspec, op) -> None:
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        self.coll.exscan(self, sbuf, rbuf, rcount, rdt, op)

    # -- nonblocking collectives (coll/nbc schedules) -------------------
    def Ibarrier(self):
        return self.coll.ibarrier(self)

    def Ibcast(self, spec, root: int = 0):
        buf, count, dt = self._spec(spec)
        return self.coll.ibcast(self, buf, count, dt, root)

    def Ireduce(self, sspec, rspec, op, root: int = 0):
        sbuf, scount, sdt = self._spec(sspec)
        if rspec is None:
            return self.coll.ireduce(self, sbuf, None, scount, sdt, op, root)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.ireduce(self, sbuf, rbuf, rcount or scount,
                                 rdt or sdt, op, root)

    def Iallreduce(self, sspec, rspec, op):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.iallreduce(self, sbuf, rbuf, rcount, rdt, op)

    def Iallgather(self, sspec, rspec):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.iallgather(self, sbuf, scount, sdt, rbuf,
                                    rcount // self.size, rdt)

    def Iallgatherv(self, sspec, rspec, rcounts, displs):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        return self.coll.iallgatherv(self, sbuf, scount, sdt, rbuf,
                                     rcounts, displs, rdt)

    def Igather(self, sspec, rspec, root: int = 0):
        sbuf, scount, sdt = self._spec(sspec)
        if self.rank == root:
            rbuf, rcount, rdt = self._spec(rspec)
            return self.coll.igather(self, sbuf, scount, sdt, rbuf,
                                     rcount // self.size, rdt, root)
        return self.coll.igather(self, sbuf, scount, sdt, None, 0, sdt,
                                 root)

    def Iscatter(self, sspec, rspec, root: int = 0):
        rbuf, rcount, rdt = self._spec(rspec)
        if self.rank == root:
            sbuf, scount, sdt = self._spec(sspec)
            return self.coll.iscatter(self, sbuf, scount // self.size, sdt,
                                      rbuf, rcount, rdt, root)
        return self.coll.iscatter(self, None, 0, rdt, rbuf, rcount, rdt,
                                  root)

    def Igatherv(self, sspec, rspec, rcounts, displs, root: int = 0):
        sbuf, scount, sdt = self._spec(sspec)
        if self.rank == root:
            rbuf, _, rdt = self._spec(rspec)
        else:
            rbuf, rdt = None, sdt
        return self.coll.igatherv(self, sbuf, scount, sdt, rbuf,
                                  rcounts, displs, rdt, root)

    def Iscatterv(self, sspec, scounts, displs, rspec, root: int = 0):
        rbuf, rcount, rdt = self._spec(rspec)
        if self.rank == root:
            sbuf, _, sdt = self._spec(sspec)
        else:
            sbuf, sdt = None, rdt
        return self.coll.iscatterv(self, sbuf, scounts, displs, sdt,
                                   rbuf, rcount, rdt, root)

    def Ialltoall(self, sspec, rspec):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.ialltoall(self, sbuf, scount // self.size, sdt,
                                   rbuf, rcount // self.size, rdt)

    def Ialltoallv(self, sspec, scounts, sdispls, rspec, rcounts, rdispls):
        sbuf, _, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        return self.coll.ialltoallv(self, sbuf, scounts, sdispls, sdt,
                                    rbuf, rcounts, rdispls, rdt)

    def Ireduce_scatter(self, sspec, rspec, rcounts, op):
        sbuf, _, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        return self.coll.ireduce_scatter(self, sbuf, rbuf, rcounts, rdt,
                                         op, sdtype=sdt)

    def Ireduce_scatter_block(self, sspec, rspec, op):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.ireduce_scatter_block(self, sbuf, rbuf, rcount,
                                               rdt, op)

    def Iscan(self, sspec, rspec, op):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.iscan(self, sbuf, rbuf, rcount, rdt, op)

    def Iexscan(self, sspec, rspec, op):
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        return self.coll.iexscan(self, sbuf, rbuf, rcount, rdt, op)

    @property
    def device(self):
        """The torch.device this rank owns (None in host-only worlds)."""
        return self.state.device

    # -- device-array collectives (tensors in, tensors out) -------------
    # The device surface: collectives on card-resident buffers return
    # a NEW tensor to every rank — one rank writing into its result
    # never changes a peer's.  Served by one stacked kernel launch
    # when every member shares one card (coll/hbm), by per-device
    # launches that read the peers' buffers when members own distinct
    # devices (coll/tpu), host-staged for host-only worlds, refused
    # (NotImplementedError) when members partly share devices.

    def allreduce_arr(self, x, op):
        return self.coll.allreduce_arr(self, x, op)

    def bcast_arr(self, x, root: int = 0):
        return self.coll.bcast_arr(self, x, root)

    def reduce_arr(self, x, op, root: int = 0):
        return self.coll.reduce_arr(self, x, op, root)

    def allgather_arr(self, x):
        return self.coll.allgather_arr(self, x)

    def alltoall_arr(self, x):
        return self.coll.alltoall_arr(self, x)

    def reduce_scatter_arr(self, x, op):
        return self.coll.reduce_scatter_block_arr(self, x, op)

    def ppermute_arr(self, x, perm):
        """perm: [(src_rank, dst_rank), ...] — neighbor shift."""
        return self.coll.ppermute_arr(self, x, perm)

    # -- nonblocking device-array collectives (the fusion surface) ------
    # Small payloads coalesce into one rendezvous and one launch per
    # (op, dtype) group per batch (coll/fusion); the returned request's
    # .result holds the output after .wait().

    def iallreduce_arr(self, x, op):
        return self.coll.iallreduce_arr(self, x, op)

    def ibcast_arr(self, x, root: int = 0):
        return self.coll.ibcast_arr(self, x, root)

    def flush_arr(self) -> None:
        """Dispatch this comm's pending fused collectives now
        (collective: every member must flush — wait()/finalize also
        flush implicitly)."""
        from ompi_tpu_torch.coll import fusion
        fusion.flush_comm(self)

    # -- device point-to-point (btl/tpu; see ompi_tpu_torch/btl/tpu) ----
    def send_arr(self, x, dst, tag: int = 0) -> None:
        from ompi_tpu_torch.btl import tpu as _tpu
        _tpu.send_arr(self, x, dst, tag)

    def recv_arr(self, src, tag: int = 0):
        from ompi_tpu_torch.btl import tpu as _tpu
        return _tpu.recv_arr(self, src, tag)

    def sendrecv_arr(self, x, dst, src, tag: int = 0):
        from ompi_tpu_torch.btl import tpu as _tpu
        return _tpu.sendrecv_arr(self, x, dst, src, tag)

    # -- topologies (ompi/mca/topo analog; ompi_tpu_torch.topo) ---------
    def Create_cart(self, dims, periods=None, reorder: bool = False):
        from ompi_tpu_torch.topo import cart_create
        return cart_create(self, dims, periods, reorder)

    def Create_graph(self, index, edges, reorder: bool = False):
        from ompi_tpu_torch.topo import graph_create
        return graph_create(self, index, edges, reorder)

    def Create_dist_graph_adjacent(self, sources, destinations,
                                   sourceweights=None, destweights=None,
                                   reorder: bool = False):
        from ompi_tpu_torch.topo import dist_graph_create_adjacent
        return dist_graph_create_adjacent(self, sources, destinations,
                                          sourceweights, destweights,
                                          reorder)

    def Topo_test(self) -> int:
        from ompi_tpu_torch.topo import UNDEFINED_TOPO
        return self.topo.kind if self.topo is not None else UNDEFINED_TOPO

    def _require_topo(self, kind: Optional[int] = None):
        """MPI_ERR_TOPOLOGY guard (cart-only accessors pass kind=CART)."""
        t = self.topo
        if t is None or (kind is not None and t.kind != kind):
            raise ValueError(
                f"{self.name} has no {'cartesian ' if kind == 1 else ''}"
                f"topology (MPI_ERR_TOPOLOGY)")
        return t

    def Get_coords(self, rank: Optional[int] = None):
        return self._require_topo(1).rank_to_coords(
            self.rank if rank is None else rank)

    def Get_cart_rank(self, coords) -> int:
        return self._require_topo(1).coords_to_rank(coords)

    def Shift(self, dim: int, disp: int = 1):
        """MPI_Cart_shift → (rank_source, rank_dest)."""
        return self._require_topo(1).shift(dim, disp, self.rank)

    def Sub(self, remain_dims):
        from ompi_tpu_torch.topo import cart_sub
        return cart_sub(self, remain_dims)

    def Get_topo(self):
        t = self.topo
        if t is None:
            return None
        if t.kind == 1:   # CART
            return (t.dims, t.periods, t.coords)
        if t.kind == 2:   # GRAPH
            return (t.index, t.edges)
        return (t.sources, t.destinations)

    # -- neighbor collectives (MPI-3 §7.6) ------------------------------
    @staticmethod
    def _nbr_block(total: int, nbrs: int, what: str) -> int:
        """Per-neighbor block count; a buffer that doesn't divide
        evenly is a count mismatch, not a silent truncation."""
        if nbrs == 0:
            return 0
        if total % nbrs:
            raise ValueError(
                f"{what} buffer of {total} elements not divisible by "
                f"{nbrs} neighbors (MPI_ERR_COUNT)")
        return total // nbrs

    def Neighbor_allgather(self, sspec, rspec) -> None:
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        topo = self._require_topo()
        nin = len(topo.in_neighbors(self.rank))
        nb.neighbor_allgather(self, sbuf, scount, sdt, rbuf,
                              self._nbr_block(rcount, nin, "recv"), rdt)

    def Neighbor_allgatherv(self, sspec, rspec, rcounts, displs) -> None:
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        nb.neighbor_allgatherv(self, sbuf, scount, sdt, rbuf, rcounts,
                               displs, rdt)

    def Neighbor_alltoall(self, sspec, rspec) -> None:
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        topo = self._require_topo()
        nout = len(topo.out_neighbors(self.rank))
        nin = len(topo.in_neighbors(self.rank))
        nb.neighbor_alltoall(self, sbuf,
                             self._nbr_block(scount, nout, "send"), sdt,
                             rbuf, self._nbr_block(rcount, nin, "recv"),
                             rdt)

    def Neighbor_alltoallv(self, sspec, scounts, sdispls, rspec, rcounts,
                           rdispls) -> None:
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, _, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        nb.neighbor_alltoallv(self, sbuf, scounts, sdispls, sdt, rbuf,
                              rcounts, rdispls, rdt)

    def Ineighbor_allgather(self, sspec, rspec):
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        nin = len(self._require_topo().in_neighbors(self.rank))
        return nb.ineighbor_allgather(
            self, sbuf, scount, sdt, rbuf,
            self._nbr_block(rcount, nin, "recv"), rdt)

    def Ineighbor_allgatherv(self, sspec, rspec, rcounts, displs):
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        self._require_topo()
        return nb.ineighbor_allgatherv(self, sbuf, scount, sdt, rbuf,
                                       rcounts, displs, rdt)

    def Ineighbor_alltoall(self, sspec, rspec):
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, scount, sdt = self._spec(sspec)
        rbuf, rcount, rdt = self._spec(rspec)
        topo = self._require_topo()
        nout = len(topo.out_neighbors(self.rank))
        nin = len(topo.in_neighbors(self.rank))
        return nb.ineighbor_alltoall(
            self, sbuf, self._nbr_block(scount, nout, "send"), sdt,
            rbuf, self._nbr_block(rcount, nin, "recv"), rdt)

    def Ineighbor_alltoallv(self, sspec, scounts, sdispls, rspec, rcounts,
                            rdispls):
        from ompi_tpu_torch.topo import neighbor as nb
        sbuf, _, sdt = self._spec(sspec)
        rbuf, _, rdt = self._spec(rspec)
        return nb.ineighbor_alltoallv(self, sbuf, scounts, sdispls, sdt,
                                      rbuf, rcounts, rdispls, rdt)

    def shift_arr(self, x, dim: int, disp: int = 1):
        """Cartesian whole-grid shift of a device tensor along `dim` —
        the comm's ppermute_arr (the device halo-exchange path).
        Ranks with no source neighbor (non-periodic edge) get zeros."""
        return self.coll.ppermute_arr(
            self, x, self._require_topo(1).shift_perm(dim, disp, self.size))

    def neighbor_allgather_arr(self, x):
        """Device-tier halo gather: every neighbour's block in MPI
        neighbor order, one meeting (see
        topo.neighbor.neighbor_allgather_arr)."""
        from ompi_tpu_torch.topo import neighbor as nb
        return nb.neighbor_allgather_arr(self, x)

    # -- management shorthands -----------------------------------------
    def Get_rank(self) -> int:
        return self.rank

    def Get_size(self) -> int:
        return self.size

    def Dup(self) -> "Communicator":
        return self.dup()

    def Split(self, color: int, key: int = 0):
        return self.split(color, key)

    def Free(self) -> None:
        self.free()

    def __repr__(self) -> str:
        return (f"Communicator({self.name}, cid={self.cid}, "
                f"rank={self.rank}/{self.size})")
