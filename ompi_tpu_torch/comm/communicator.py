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

# respawn recovery epochs partition the cid space into disjoint bands
# (epoch E allocates from [E*STRIDE, (E+1)*STRIDE)): a fragment or
# cached plan addressed to a pre-failure cid can never alias a
# communicator built after an in-job rank replacement.
EPOCH_CID_STRIDE = 65536

# Resident sessions band the same space along a DISJOINT outer
# dimension: session b owns [b*SESSION_CID_STRIDE,
# (b+1)*SESSION_CID_STRIDE), subdivided into its own respawn-epoch
# bands.  The dimensions must not be additive — (band+epoch)*STRIDE
# would alias session k at epoch e with session k+e at epoch 0.
MAX_RESPAWN_EPOCHS = 1024
SESSION_CID_STRIDE = MAX_RESPAWN_EPOCHS * EPOCH_CID_STRIDE

UNDEFINED = -32766

COMM_TYPE_SHARED = 1


def _cid_proposal(state) -> int:
    """This rank's lower bound for a cid agreement: its smallest unused
    cid at or above the floor of its band (the session's outer band,
    then the respawn epoch's inside it)."""
    floor = (state.cid_band * SESSION_CID_STRIDE
             + state.respawn_epoch * EPOCH_CID_STRIDE)
    proposal = state.next_cid_local()
    if proposal < floor:
        proposal = floor
        while proposal in state.comms:
            proposal += 1
    return proposal


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
        # Python surface default is ERRORS_RETURN (raising IS the
        # error return; install ERRORS_ARE_FATAL for C semantics —
        # see ompi_tpu_torch/errhandler.py, ref: ompi/errhandler)
        from ompi_tpu_torch import errhandler as _eh
        self.errhandler = _eh.ERRORS_RETURN
        self.attrs: Dict[int, Any] = {}
        self.info = None  # MPI_Info hints (Set_info/Get_info)
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
        (ref: ompi_comm_nextcid multi-round agreement).  The proposal
        is floored into this rank's band: the session's outer band
        (state.cid_band * SESSION_CID_STRIDE) and, inside it, the
        respawn epoch's (state.respawn_epoch * EPOCH_CID_STRIDE), so
        derived comms of concurrent sessions never alias."""
        while True:
            agreed = self._allreduce_max_int(_cid_proposal(self.state),
                                             TAG_CID)
            ok = 1 if agreed not in self.state.comms else 0
            all_ok = self._allreduce_max_int(-ok, TAG_CID)  # max(-ok)=0 iff any not ok
            if all_ok == -1:
                return agreed
            # else: someone had it taken; reserve and retry
            self.state.comms.setdefault(agreed, None)

    # -- management operations ------------------------------------------
    def dup(self, name: str = "") -> "Communicator":
        from ompi_tpu_torch import attrs as _attrs
        cid = self.next_cid()
        new = Communicator(self.state, cid, Group(self.group),
                           name or f"{self.name}-dup")
        new.topo = self.topo  # MPI_Comm_dup carries the topology over
        new.errhandler = self.errhandler
        if self.info is not None:
            new.info = self.info.dup()
        _attrs.copy_all(self, new)  # attribute copy callbacks
        return new

    def idup(self, name: str = ""):
        """MPI_Comm_idup (ref: ompi/mpi/c/comm_idup.c): returns
        (newcomm, request).  The CID agreement runs eagerly — every
        member is inside idup anyway (it is collective), so the
        request is born complete; the value of the nonblocking form
        is API fidelity, not overlap, at this altitude."""
        from ompi_tpu_torch.pml.request import CompletedRequest
        new = self.dup(name)
        return new, CompletedRequest(self.state.progress)

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
            agreed = shim._allreduce_max_int(_cid_proposal(self.state),
                                             wire_tag)
            ok = 1 if agreed not in self.state.comms else 0
            all_ok = shim._allreduce_max_int(-ok, wire_tag)
            if all_ok == -1:
                new = Communicator(self.state, agreed, group)
                new.errhandler = self.errhandler  # MPI: children inherit
                return new
            self.state.comms.setdefault(agreed, None)

    def create(self, group: Group) -> Optional["Communicator"]:
        """MPI_Comm_create: collective over the parent; ranks outside
        `group` get None (MPI_COMM_NULL)."""
        cid = self.next_cid()
        if group.rank_of(self.state.rank) == UNDEFINED:
            self.state.comms.setdefault(cid, None)  # keep cid reserved
            return None
        new = Communicator(self.state, cid, group)
        new.errhandler = self.errhandler  # MPI: children inherit
        return new

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
        new = Communicator(self.state, cid, Group(mine))
        new.errhandler = self.errhandler  # MPI: children inherit
        return new

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
        from ompi_tpu_torch import attrs as _attrs
        _attrs.delete_all(self)  # attribute delete callbacks
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

    # -- ULFM fault tolerance (ompi_tpu_torch/ft/ulfm; the MPIX_Comm_*
    # surface of the MPI-4 FT proposal) ---------------------------------
    def revoke(self) -> None:
        """MPIX_Comm_revoke: poison this communicator on every member
        (NOT collective — any member may call it).  In-flight and
        future operations drain with ERR_REVOKED; agree/shrink keep
        working — they are the escape hatch."""
        from ompi_tpu_torch.ft import ulfm as _ulfm
        _ulfm.publish_revoke(self)

    def is_revoked(self) -> bool:
        u = self.state.ulfm
        if u is None:
            return False
        u.poll()
        return (self.cid, tuple(self.group)) in u.revoked

    def get_failed(self) -> List[int]:
        """MPIX_Comm_get_failed analog: comm ranks known failed."""
        u = self.state.ulfm
        if u is None:
            return []
        u.poll()
        return [r for r, g in enumerate(self.group) if g in u.failed]

    def ack_failed(self) -> int:
        """MPIX_Comm_ack_failed: acknowledge the current failure set
        (re-arms ANY_SOURCE receives); returns how many are acked."""
        u = self.state.ulfm
        if u is None:
            return 0
        u.poll()
        u.acked |= u.failed.intersection(self.group)
        return sum(1 for g in self.group if g in u.acked)

    def agree(self, flag=True) -> bool:
        """MPIX_Comm_agree: fault-tolerant agreement — every survivor
        returns the same AND of the contributed flags, no matter when
        members die (see ompi_tpu_torch/ft/ulfm.agree)."""
        from ompi_tpu_torch.ft import ulfm as _ulfm
        return _ulfm.agree(self, flag)

    def shrink(self, name: str = "") -> "Communicator":
        """MPIX_Comm_shrink: a new communicator of the survivors (its
        device mesh rebuilt from their devices on first use, the old
        comm's per-group caches dropped).  Collective over the
        survivors."""
        from ompi_tpu_torch.ft import ulfm as _ulfm
        return _ulfm.shrink(self, name)

    # -- error handlers (ref: ompi/errhandler) --------------------------
    def Set_errhandler(self, handler) -> None:
        self.errhandler = handler

    def Get_errhandler(self):
        return self.errhandler

    def Call_errhandler(self, errorcode: int) -> None:
        from ompi_tpu_torch import errhandler as _eh
        _eh.dispatch(self, _eh.MPIException(errorcode))

    # -- attributes (ref: ompi/attribute/attribute.c) -------------------
    def Set_attr(self, keyval: int, value: Any) -> None:
        from ompi_tpu_torch import attrs as _attrs
        _attrs.set_attr(self, keyval, value)

    def Get_attr(self, keyval: int):
        from ompi_tpu_torch import attrs as _attrs
        return _attrs.get_attr(self, keyval)

    def Delete_attr(self, keyval: int) -> None:
        from ompi_tpu_torch import attrs as _attrs
        _attrs.delete_attr(self, keyval)

    # -- info hints (ref: ompi/info/info.c) -----------------------------
    def Set_info(self, info) -> None:
        self.info = info

    def Get_info(self):
        from ompi_tpu_torch.info import Info
        return self.info.dup() if self.info is not None else Info()

    # ------------------------------------------------------------------
    # Public MPI API (mpi4py-flavored buffer methods).  Buffer specs:
    # a numpy array (count/datatype inferred), or (buf, datatype), or
    # (buf, count, datatype).  Mirrors the C surface (ref:
    # ompi/mpi/c/*.c) at Python altitude; the flat MPI_* names live in
    # ompi_tpu_torch.mpi.
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

    # -- intercommunicators + dynamic process management ----------------
    @property
    def is_inter(self) -> bool:
        return False

    def create_intercomm(self, local_leader: int, peer_comm,
                         remote_leader: int, tag: int = 0):
        """MPI_Intercomm_create (ref: ompi/mpi/c/intercomm_create.c)."""
        from .intercomm import intercomm_create
        return intercomm_create(self, local_leader, peer_comm,
                                remote_leader, tag)

    def spawn(self, cmd: str, args=(), maxprocs: int = 1,
              root: int = 0):
        """MPI_Comm_spawn (ref: ompi/dpm/dpm.c)."""
        from .dpm import comm_spawn
        return comm_spawn(self, cmd, list(args), maxprocs, root)

    def spawn_multiple(self, specs, root: int = 0):
        """MPI_Comm_spawn_multiple: specs = [(cmd, args, n), ...]."""
        from .dpm import comm_spawn_multiple
        return comm_spawn_multiple(self, specs, root)

    def disconnect(self) -> None:
        """MPI_Comm_disconnect (ref: ompi/mpi/c/comm_disconnect.c):
        barrier (pending communication must drain) then free."""
        self.Barrier()
        self.free()

    def accept(self, port: str, root: int = 0):
        from .dpm import comm_accept
        return comm_accept(self, port, root)

    def connect(self, port: str, root: int = 0):
        from .dpm import comm_connect
        return comm_connect(self, port, root)

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

    # -- buffered / ready sends (ref: ompi/mpi/c/bsend.c, rsend.c) ------
    def Bsend(self, spec, dest: int, tag: int = 0) -> None:
        from ompi_tpu_torch.pml import persistent as pers
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        pers.bsend(self, buf, count, dt, dest, tag)

    def Ibsend(self, spec, dest: int, tag: int = 0):
        from ompi_tpu_torch.pml import persistent as pers
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        return pers.ibsend(self, buf, count, dt, dest, tag)

    # a ready send is correct whenever a standard send is; the
    # reference's rsend is likewise standard-send under ob1.  This
    # silently legalizes erroneous programs (no matching-recv check),
    # so the behavior is declared in the registry
    # (pml_ob1_rsend_is_standard) for ompi_info discoverability.
    def Rsend(self, spec, dest: int, tag: int = 0) -> None:
        self.Send(spec, dest, tag)

    def Irsend(self, spec, dest: int, tag: int = 0):
        return self.Isend(spec, dest, tag)

    # -- persistent requests (ref: ompi/mpi/c/send_init.c et al.) -------
    def Send_init(self, spec, dest: int, tag: int = 0):
        from ompi_tpu_torch.pml.persistent import PersistentRequest
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        return PersistentRequest(self, PersistentRequest.KIND_SEND,
                                 buf, count, dt, dest, tag)

    def Ssend_init(self, spec, dest: int, tag: int = 0):
        from ompi_tpu_torch.pml.ob1 import MODE_SYNC
        from ompi_tpu_torch.pml.persistent import PersistentRequest
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        return PersistentRequest(self, PersistentRequest.KIND_SEND,
                                 buf, count, dt, dest, tag, MODE_SYNC)

    def Bsend_init(self, spec, dest: int, tag: int = 0):
        from ompi_tpu_torch.pml.persistent import PersistentRequest
        self._check_tag(tag)
        buf, count, dt = self._spec(spec)
        return PersistentRequest(self, PersistentRequest.KIND_SEND,
                                 buf, count, dt, dest, tag, "buffered")

    def Recv_init(self, spec, source: int = -1, tag: int = -1):
        from ompi_tpu_torch.pml.persistent import PersistentRequest
        self._check_tag(tag, recv=True)
        buf, count, dt = self._spec(spec)
        return PersistentRequest(self, PersistentRequest.KIND_RECV,
                                 buf, count, dt, source, tag)

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


# ---------------------------------------------------------------------------
# errhandler-guarded dispatch: every public operation routes raised
# errors through the communicator's installed handler
# (ref: OMPI_ERRHANDLER_INVOKE wrapping each ompi/mpi/c binding).
# With the default ERRORS_RETURN this re-raises unchanged; with
# ERRORS_ARE_FATAL the job aborts; user handlers run first.
# ---------------------------------------------------------------------------

def _guard(method):
    import functools

    @functools.wraps(method)
    def wrapped(self, *args, **kwargs):
        try:
            return method(self, *args, **kwargs)
        except (SystemExit, KeyboardInterrupt):
            raise
        except BaseException as exc:  # noqa: BLE001
            from ompi_tpu_torch import errhandler as _eh
            _eh.dispatch(self, exc)

    return wrapped


_GUARDED = (
    "Send", "Recv", "Isend", "Irecv", "Ssend", "Rsend", "Bsend",
    "Sendrecv", "Probe", "Iprobe", "Mprobe", "Mrecv",
    "Barrier", "Bcast", "Reduce", "Allreduce", "Allgather",
    "Allgatherv", "Gather", "Gatherv", "Scatter", "Scatterv",
    "Alltoall", "Alltoallv", "Reduce_scatter", "Reduce_scatter_block",
    "Scan", "Exscan",
)
for _name in _GUARDED:
    _m = getattr(Communicator, _name, None)
    if _m is not None:
        setattr(Communicator, _name, _guard(_m))
del _name, _m
