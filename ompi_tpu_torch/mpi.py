"""Flat MPI_* surface: C-binding-shaped names over the object API.

The analog of ompi/mpi/c's 385 one-function files (ref:
ompi/mpi/c/send.c:78, allreduce.c:110 — arg checking + handle
translation + dispatch): each MPI_* function here translates to the
corresponding Communicator/Window method.  Predefined handles
(datatypes, ops, constants) are re-exported under their MPI names so
a reference user can port code token-for-token:

    from ompi_tpu_torch import mpi as MPI
    MPI.MPI_Init()
    rank = MPI.MPI_Comm_rank(MPI.MPI_COMM_WORLD())
    MPI.MPI_Send(buf, 4, MPI.MPI_DOUBLE, 1, 0, comm)

Like PMPI in the reference (ompi/mpi/c/init.c:35-37 weak symbols),
every MPI_* name has a PMPI_* alias created at import time, so
profiling interposers can wrap MPI_* while calling through PMPI_*.
"""

from __future__ import annotations

import sys as _sys
from typing import List, Optional

import ompi_tpu_torch as _top
from ompi_tpu_torch.datatype.engine import (  # noqa: F401
    BYTE as MPI_BYTE, PACKED as MPI_PACKED, CHAR as MPI_CHAR,
    SHORT as MPI_SHORT, INT as MPI_INT, LONG as MPI_LONG,
    LONG_LONG as MPI_LONG_LONG, UNSIGNED as MPI_UNSIGNED,
    UNSIGNED_LONG as MPI_UNSIGNED_LONG, INT8_T as MPI_INT8_T,
    INT16_T as MPI_INT16_T, INT32_T as MPI_INT32_T,
    INT64_T as MPI_INT64_T, UINT8_T as MPI_UINT8_T,
    UINT16_T as MPI_UINT16_T, UINT32_T as MPI_UINT32_T,
    UINT64_T as MPI_UINT64_T, FLOAT as MPI_FLOAT, DOUBLE as MPI_DOUBLE,
    C_BOOL as MPI_C_BOOL, C_FLOAT_COMPLEX as MPI_C_FLOAT_COMPLEX,
    C_DOUBLE_COMPLEX as MPI_C_DOUBLE_COMPLEX, AINT as MPI_AINT,
    OFFSET as MPI_OFFSET, COUNT as MPI_COUNT,
    FLOAT_INT as MPI_FLOAT_INT, DOUBLE_INT as MPI_DOUBLE_INT,
    LONG_INT as MPI_LONG_INT,
    contiguous as MPI_Type_contiguous, vector as MPI_Type_vector,
    indexed as MPI_Type_indexed, struct as MPI_Type_create_struct,
)
from ompi_tpu_torch.op.op import (  # noqa: F401
    MAX as MPI_MAX, MIN as MPI_MIN, SUM as MPI_SUM, PROD as MPI_PROD,
    LAND as MPI_LAND, BAND as MPI_BAND, LOR as MPI_LOR, BOR as MPI_BOR,
    LXOR as MPI_LXOR, BXOR as MPI_BXOR, MAXLOC as MPI_MAXLOC,
    MINLOC as MPI_MINLOC, REPLACE as MPI_REPLACE, NO_OP as MPI_NO_OP,
)
from ompi_tpu_torch.pml.request import (  # noqa: F401
    ANY_SOURCE as MPI_ANY_SOURCE, ANY_TAG as MPI_ANY_TAG,
    PROC_NULL as MPI_PROC_NULL, SUCCESS as MPI_SUCCESS,
    Status, wait_all, wait_any, wait_some, test_all,
)
from ompi_tpu_torch.comm.communicator import (  # noqa: F401
    COMM_TYPE_SHARED as MPI_COMM_TYPE_SHARED, UNDEFINED as MPI_UNDEFINED,
    Communicator, Group,
)

MPI_COMM_NULL = None
MPI_STATUS_IGNORE = None

# Handles whose defining modules import the collective framework, and
# with it torch: resolved at first use, so that importing this module
# stays as cheap as importing the package.
_LAZY = {"MPI_IN_PLACE": ("ompi_tpu_torch.coll.buffers", "IN_PLACE")}
_LAZY.update((f"MPI_{n}", ("ompi_tpu_torch.io", n)) for n in (
    "MODE_APPEND", "MODE_CREATE", "MODE_DELETE_ON_CLOSE", "MODE_EXCL",
    "MODE_RDONLY", "MODE_RDWR", "MODE_SEQUENTIAL", "MODE_UNIQUE_OPEN",
    "MODE_WRONLY", "SEEK_CUR", "SEEK_END", "SEEK_SET"))


def __getattr__(name: str):
    spec = _LAZY.get(name)
    if spec is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    import importlib
    value = getattr(importlib.import_module(spec[0]), spec[1])
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))


# -- environment ------------------------------------------------------------

def MPI_Init(args=None):
    return _top.init()


def MPI_Finalize():
    _top.finalize()


def MPI_Initialized() -> bool:
    return _top.initialized()


def MPI_Finalized() -> bool:
    return _top.finalized()


def MPI_COMM_WORLD() -> Communicator:
    from ompi_tpu_torch.runtime import state as _st
    return _st.current().comm_world


def MPI_COMM_SELF() -> Communicator:
    from ompi_tpu_torch.runtime import state as _st
    return _st.current().comm_self


def MPI_Abort(comm, errorcode: int = 1):
    comm.abort(errorcode)


def MPI_Wtime() -> float:
    import time
    return time.monotonic()


def MPI_Get_processor_name() -> str:
    import socket
    return socket.gethostname()


# -- communicator management ------------------------------------------------

def MPI_Comm_rank(comm) -> int:
    return comm.rank


def MPI_Comm_size(comm) -> int:
    return comm.size


def MPI_Comm_dup(comm):
    return comm.dup()


def MPI_Comm_split(comm, color, key=0):
    return comm.split(color, key)


def MPI_Comm_split_type(comm, split_type, key=0):
    return comm.split_type(split_type, key)


def MPI_Comm_create(comm, group):
    return comm.create(group)


def MPI_Comm_free(comm):
    comm.free()


def MPI_Comm_group(comm):
    return comm.group_obj()


def MPI_Comm_compare(a, b) -> str:
    if a is b:
        return "ident"
    if a.group == b.group:      # same members, same order
        return "congruent"
    if sorted(a.group) == sorted(b.group):  # same members, reordered
        return "similar"
    return "unequal"


def MPI_Group_size(group) -> int:
    return group.size


def MPI_Group_rank(group) -> int:
    from ompi_tpu_torch.runtime import state as _st
    return group.rank_of(_st.current().rank)


def MPI_Group_incl(group, ranks):
    return group.incl(ranks)


def MPI_Group_excl(group, ranks):
    return group.excl(ranks)


def MPI_Group_union(a, b):
    return a.union(b)


def MPI_Group_intersection(a, b):
    return a.intersection(b)


def MPI_Group_difference(a, b):
    return a.difference(b)


def MPI_Group_translate_ranks(a, ranks, b) -> List[int]:
    return [a.translate(b, r) for r in ranks]


# -- point-to-point ---------------------------------------------------------

def MPI_Send(buf, count, datatype, dest, tag, comm):
    comm.Send((buf, count, datatype), dest, tag)


def MPI_Ssend(buf, count, datatype, dest, tag, comm):
    comm.Ssend((buf, count, datatype), dest, tag)


def MPI_Bsend(buf, count, datatype, dest, tag, comm):
    comm.Bsend((buf, count, datatype), dest, tag)


def MPI_Rsend(buf, count, datatype, dest, tag, comm):
    comm.Rsend((buf, count, datatype), dest, tag)


def MPI_Recv(buf, count, datatype, source, tag, comm) -> Status:
    return comm.Recv((buf, count, datatype), source, tag)


def MPI_Isend(buf, count, datatype, dest, tag, comm):
    return comm.Isend((buf, count, datatype), dest, tag)


def MPI_Issend(buf, count, datatype, dest, tag, comm):
    return comm.Issend((buf, count, datatype), dest, tag)


def MPI_Ibsend(buf, count, datatype, dest, tag, comm):
    return comm.Ibsend((buf, count, datatype), dest, tag)


def MPI_Irsend(buf, count, datatype, dest, tag, comm):
    return comm.Irsend((buf, count, datatype), dest, tag)


def MPI_Irecv(buf, count, datatype, source, tag, comm):
    return comm.Irecv((buf, count, datatype), source, tag)


def MPI_Sendrecv(sbuf, scount, sdt, dest, stag,
                 rbuf, rcount, rdt, source, rtag, comm) -> Status:
    return comm.Sendrecv((sbuf, scount, sdt), dest, stag,
                         (rbuf, rcount, rdt), source, rtag)


def MPI_Probe(source, tag, comm) -> Status:
    return comm.Probe(source, tag)


def MPI_Iprobe(source, tag, comm) -> Optional[Status]:
    return comm.Iprobe(source, tag)


def MPI_Mprobe(source, tag, comm):
    return comm.Mprobe(source, tag)


def MPI_Mrecv(buf, count, datatype, message, comm) -> Status:
    return comm.Mrecv((buf, count, datatype), message)


def MPI_Wait(request, status=None) -> Status:
    return request.wait()


def MPI_Test(request) -> bool:
    return request.test()


def MPI_Waitall(requests, statuses=None) -> List[Status]:
    return wait_all(requests)


def MPI_Waitany(requests) -> int:
    return wait_any(requests)


def MPI_Waitsome(requests) -> List[int]:
    return wait_some(requests)


def MPI_Testall(requests) -> bool:
    return test_all(requests)


def MPI_Cancel(request):
    request.cancel()


def MPI_Get_count(status, datatype) -> int:
    return status.get_count(datatype)


# -- persistent + buffered --------------------------------------------------

def MPI_Send_init(buf, count, datatype, dest, tag, comm):
    return comm.Send_init((buf, count, datatype), dest, tag)


def MPI_Bsend_init(buf, count, datatype, dest, tag, comm):
    return comm.Bsend_init((buf, count, datatype), dest, tag)


def MPI_Ssend_init(buf, count, datatype, dest, tag, comm):
    return comm.Ssend_init((buf, count, datatype), dest, tag)


def MPI_Recv_init(buf, count, datatype, source, tag, comm):
    return comm.Recv_init((buf, count, datatype), source, tag)


def MPI_Start(request):
    request.start()


def MPI_Startall(requests):
    from ompi_tpu_torch.pml.persistent import start_all
    start_all(requests)


def MPI_Request_free(request):
    request.free()


def MPI_Buffer_attach(size_or_buf):
    _top.attach_buffer(size_or_buf)


def MPI_Buffer_detach() -> int:
    return _top.detach_buffer()


# -- collectives ------------------------------------------------------------

def MPI_Barrier(comm):
    comm.Barrier()


def MPI_Bcast(buf, count, datatype, root, comm):
    comm.Bcast((buf, count, datatype), root)


def MPI_Reduce(sbuf, rbuf, count, datatype, op, root, comm):
    comm.Reduce((sbuf, count, datatype),
                None if rbuf is None else (rbuf, count, datatype),
                op, root)


def MPI_Allreduce(sbuf, rbuf, count, datatype, op, comm):
    comm.Allreduce((sbuf, count, datatype), (rbuf, count, datatype), op)


def MPI_Allgather(sbuf, scount, sdt, rbuf, rcount, rdt, comm):
    comm.Allgather((sbuf, scount, sdt), (rbuf, rcount * comm.size, rdt))


def MPI_Allgatherv(sbuf, scount, sdt, rbuf, rcounts, displs, rdt, comm):
    comm.Allgatherv((sbuf, scount, sdt), (rbuf, sum(rcounts), rdt),
                    rcounts, displs)


def MPI_Gather(sbuf, scount, sdt, rbuf, rcount, rdt, root, comm):
    comm.Gather((sbuf, scount, sdt),
                None if comm.rank != root else
                (rbuf, rcount * comm.size, rdt), root)


def MPI_Scatter(sbuf, scount, sdt, rbuf, rcount, rdt, root, comm):
    comm.Scatter(None if comm.rank != root else
                 (sbuf, scount * comm.size, sdt),
                 (rbuf, rcount, rdt), root)


def MPI_Alltoall(sbuf, scount, sdt, rbuf, rcount, rdt, comm):
    comm.Alltoall((sbuf, scount * comm.size, sdt),
                  (rbuf, rcount * comm.size, rdt))


def MPI_Alltoallv(sbuf, scounts, sdispls, sdt, rbuf, rcounts, rdispls,
                  rdt, comm):
    comm.Alltoallv((sbuf, 0, sdt), scounts, sdispls, (rbuf, 0, rdt),
                   rcounts, rdispls)


def MPI_Reduce_scatter(sbuf, rbuf, rcounts, datatype, op, comm):
    comm.Reduce_scatter((sbuf, sum(rcounts), datatype),
                        (rbuf, rcounts[comm.rank], datatype), rcounts, op)


def MPI_Reduce_scatter_block(sbuf, rbuf, rcount, datatype, op, comm):
    comm.Reduce_scatter_block((sbuf, rcount * comm.size, datatype),
                              (rbuf, rcount, datatype), op)


def MPI_Scan(sbuf, rbuf, count, datatype, op, comm):
    comm.Scan((sbuf, count, datatype), (rbuf, count, datatype), op)


def MPI_Exscan(sbuf, rbuf, count, datatype, op, comm):
    comm.Exscan((sbuf, count, datatype), (rbuf, count, datatype), op)


def MPI_Ibarrier(comm):
    return comm.Ibarrier()


def MPI_Ibcast(buf, count, datatype, root, comm):
    return comm.Ibcast((buf, count, datatype), root)


def MPI_Iallreduce(sbuf, rbuf, count, datatype, op, comm):
    return comm.Iallreduce((sbuf, count, datatype),
                           (rbuf, count, datatype), op)


def MPI_Ialltoall(sbuf, scount, sdt, rbuf, rcount, rdt, comm):
    return comm.Ialltoall((sbuf, scount * comm.size, sdt),
                          (rbuf, rcount * comm.size, rdt))


# -- topologies -------------------------------------------------------------

def MPI_Dims_create(nnodes, ndims, dims=None) -> List[int]:
    from ompi_tpu_torch.topo import dims_create
    return dims_create(nnodes, ndims, dims)


def MPI_Cart_create(comm, ndims, dims, periods, reorder=False):
    return comm.Create_cart(dims, periods, reorder)


def MPI_Cart_coords(comm, rank) -> List[int]:
    return comm.Get_coords(rank)


def MPI_Cart_rank(comm, coords) -> int:
    return comm.Get_cart_rank(coords)


def MPI_Cart_shift(comm, direction, disp):
    return comm.Shift(direction, disp)


def MPI_Cart_sub(comm, remain_dims):
    return comm.Sub(remain_dims)


def MPI_Topo_test(comm) -> int:
    return comm.Topo_test()


def MPI_Neighbor_allgather(sbuf, scount, sdt, rbuf, rcount, rdt, comm):
    nin = len(comm.topo.in_neighbors(comm.rank))
    comm.Neighbor_allgather((sbuf, scount, sdt),
                            (rbuf, rcount * nin, rdt))


def MPI_Neighbor_alltoall(sbuf, scount, sdt, rbuf, rcount, rdt, comm):
    nin = len(comm.topo.in_neighbors(comm.rank))
    nout = len(comm.topo.out_neighbors(comm.rank))
    comm.Neighbor_alltoall((sbuf, scount * nout, sdt),
                           (rbuf, rcount * nin, rdt))


# -- one-sided --------------------------------------------------------------

def MPI_Win_create(base, size=None, disp_unit=None, info=None, comm=None):
    from ompi_tpu_torch.osc import window as _w
    return _w.create(comm, base, disp_unit)


def MPI_Win_fence(assert_=0, win=None):
    win.fence()


def MPI_Win_lock(lock_type, rank, assert_=0, win=None):
    win.lock(rank, lock_type)


def MPI_Win_unlock(rank, win=None):
    win.unlock(rank)


def MPI_Put(obuf, ocount, odt, target, tdisp, tcount, tdt, win):
    win.put(obuf, target, tdisp)


def MPI_Get(obuf, ocount, odt, target, tdisp, tcount, tdt, win):
    win.get(obuf, target, tdisp)


def MPI_Accumulate(obuf, ocount, odt, target, tdisp, tcount, tdt, op, win):
    win.accumulate(obuf, target, tdisp, op=op)


# -- MPI-IO -----------------------------------------------------------------

# MPI_MODE_* and MPI_SEEK_* resolve lazily (_LAZY, above).


def MPI_File_open(comm, filename, amode, info=None):
    from ompi_tpu_torch import io as _io
    return _io.open(comm, filename, amode, info)


def MPI_File_close(fh):
    fh.close()


def MPI_File_delete(filename, info=None):
    from ompi_tpu_torch import io as _io
    _io.delete(filename)


def MPI_File_set_view(fh, disp, etype, filetype, datarep="native",
                      info=None):
    fh.set_view(disp, etype, filetype, datarep)


def MPI_File_seek(fh, offset, whence=0):  # MPI_SEEK_SET
    fh.seek(offset, whence)


def MPI_File_get_position(fh) -> int:
    return fh.get_position()


def MPI_File_get_size(fh) -> int:
    return fh.get_size()


def MPI_File_set_size(fh, size):
    fh.set_size(size)


def MPI_File_sync(fh):
    fh.sync()


def MPI_File_read(fh, buf, count, datatype) -> Status:
    return fh.read((buf, count, datatype))


def MPI_File_write(fh, buf, count, datatype) -> Status:
    return fh.write((buf, count, datatype))


def MPI_File_read_at(fh, offset, buf, count, datatype) -> Status:
    return fh.read_at(offset, (buf, count, datatype))


def MPI_File_write_at(fh, offset, buf, count, datatype) -> Status:
    return fh.write_at(offset, (buf, count, datatype))


def MPI_File_read_all(fh, buf, count, datatype) -> Status:
    return fh.read_all((buf, count, datatype))


def MPI_File_write_all(fh, buf, count, datatype) -> Status:
    return fh.write_all((buf, count, datatype))


def MPI_File_read_at_all(fh, offset, buf, count, datatype) -> Status:
    return fh.read_at_all(offset, (buf, count, datatype))


def MPI_File_write_at_all(fh, offset, buf, count, datatype) -> Status:
    return fh.write_at_all(offset, (buf, count, datatype))


def MPI_File_read_shared(fh, buf, count, datatype) -> Status:
    return fh.read_shared((buf, count, datatype))


def MPI_File_write_shared(fh, buf, count, datatype) -> Status:
    return fh.write_shared((buf, count, datatype))


def MPI_File_read_ordered(fh, buf, count, datatype) -> Status:
    return fh.read_ordered((buf, count, datatype))


def MPI_File_write_ordered(fh, buf, count, datatype) -> Status:
    return fh.write_ordered((buf, count, datatype))


def MPI_File_iread(fh, buf, count, datatype):
    return fh.iread((buf, count, datatype))


def MPI_File_iwrite(fh, buf, count, datatype):
    return fh.iwrite((buf, count, datatype))


def MPI_File_iread_at(fh, offset, buf, count, datatype):
    return fh.iread_at(offset, (buf, count, datatype))


def MPI_File_iwrite_at(fh, offset, buf, count, datatype):
    return fh.iwrite_at(offset, (buf, count, datatype))


# -- error handlers (ref: ompi/errhandler, ompi/mpi/c/comm_set_errhandler.c)
from ompi_tpu_torch.errhandler import (  # noqa: E402,F401
    ERRORS_ARE_FATAL as MPI_ERRORS_ARE_FATAL,
    ERRORS_RETURN as MPI_ERRORS_RETURN,
    ERRORS_ABORT as MPI_ERRORS_ABORT,
    Errhandler, MPIException, error_string as _error_string,
    classify as _classify,
)
from ompi_tpu_torch import errhandler as _eh_mod  # noqa: E402

MPI_ERR_LASTCODE = _eh_mod.ERR_LASTCODE
for _k in dir(_eh_mod):
    if _k.startswith("ERR_"):
        globals()["MPI_" + _k] = getattr(_eh_mod, _k)


def MPI_Comm_create_errhandler(fn):
    return Errhandler(fn)


MPI_Win_create_errhandler = MPI_Comm_create_errhandler
MPI_File_create_errhandler = MPI_Comm_create_errhandler


def MPI_Errhandler_free(handler):
    return None


def MPI_Comm_set_errhandler(comm, handler):
    comm.Set_errhandler(handler)


def MPI_Comm_get_errhandler(comm):
    return comm.Get_errhandler()


def MPI_Comm_call_errhandler(comm, errorcode: int):
    comm.Call_errhandler(errorcode)


def MPI_Win_set_errhandler(win, handler):
    win.Set_errhandler(handler)


def MPI_Win_get_errhandler(win):
    return win.Get_errhandler()


def MPI_Win_call_errhandler(win, errorcode: int):
    win.Call_errhandler(errorcode)


def MPI_File_set_errhandler(fh, handler):
    fh.Set_errhandler(handler)


def MPI_File_get_errhandler(fh):
    return fh.Get_errhandler()


def MPI_File_call_errhandler(fh, errorcode: int):
    fh.Call_errhandler(errorcode)


def MPI_Error_class(errorcode: int) -> int:
    return errorcode  # codes ARE classes here (ref: errcode.c identity)


def MPI_Error_string(errorcode: int) -> str:
    return _error_string(errorcode)


# -- attributes (ref: ompi/attribute/attribute.c) ----------------------------
from ompi_tpu_torch import attrs as _attrs_mod  # noqa: E402

MPI_TAG_UB = _attrs_mod.TAG_UB
MPI_WTIME_IS_GLOBAL = _attrs_mod.WTIME_IS_GLOBAL
MPI_UNIVERSE_SIZE = _attrs_mod.UNIVERSE_SIZE
MPI_APPNUM = _attrs_mod.APPNUM
MPI_KEYVAL_INVALID = -1


def MPI_Comm_create_keyval(copy_fn=None, delete_fn=None,
                           extra_state=None) -> int:
    return _attrs_mod.create_keyval(copy_fn, delete_fn, extra_state)


MPI_Win_create_keyval = MPI_Comm_create_keyval
MPI_Type_create_keyval = MPI_Comm_create_keyval


def MPI_Comm_free_keyval(keyval: int):
    _attrs_mod.free_keyval(keyval)


MPI_Win_free_keyval = MPI_Comm_free_keyval
MPI_Type_free_keyval = MPI_Comm_free_keyval


def MPI_Comm_set_attr(comm, keyval: int, value):
    _attrs_mod.set_attr(comm, keyval, value)


def MPI_Comm_get_attr(comm, keyval: int):
    return _attrs_mod.get_attr(comm, keyval)


def MPI_Comm_delete_attr(comm, keyval: int):
    _attrs_mod.delete_attr(comm, keyval)


MPI_Win_set_attr = MPI_Comm_set_attr
MPI_Win_get_attr = MPI_Comm_get_attr
MPI_Win_delete_attr = MPI_Comm_delete_attr
# deprecated MPI-1 names
MPI_Attr_put = MPI_Comm_set_attr
MPI_Attr_get = MPI_Comm_get_attr
MPI_Attr_delete = MPI_Comm_delete_attr
MPI_Keyval_create = MPI_Comm_create_keyval
MPI_Keyval_free = MPI_Comm_free_keyval


# -- info objects (ref: ompi/info/info.c) ------------------------------------
from ompi_tpu_torch.info import Info as _Info, info_env as _info_env  # noqa: E402

MPI_INFO_NULL = None
MPI_MAX_INFO_KEY = 255
MPI_MAX_INFO_VAL = 1024


def MPI_Info_create() -> _Info:
    return _Info()


def MPI_Info_set(info: _Info, key: str, value: str):
    info.set(key, value)


def MPI_Info_get(info: _Info, key: str):
    return info.get(key)


def MPI_Info_delete(info: _Info, key: str):
    info.delete(key)


def MPI_Info_get_nkeys(info: _Info) -> int:
    return info.nkeys()


def MPI_Info_get_nthkey(info: _Info, n: int) -> str:
    return info.nthkey(n)


def MPI_Info_dup(info: _Info) -> _Info:
    return info.dup()


def MPI_Info_free(info: _Info):
    return None


def MPI_Info_env() -> _Info:
    from ompi_tpu_torch.runtime import state as _st
    return _info_env(_st.maybe_current())


def MPI_Comm_set_info(comm, info):
    comm.Set_info(info)


def MPI_Comm_get_info(comm):
    return comm.Get_info()


# -- intercommunicators + dpm (ref: ompi/mpi/c/intercomm_create.c,
# ompi/dpm/dpm.c) -------------------------------------------------------------
from ompi_tpu_torch.comm.intercomm import ROOT as MPI_ROOT  # noqa: E402,F401


def MPI_Intercomm_create(local_comm, local_leader, peer_comm,
                         remote_leader, tag=0):
    return local_comm.create_intercomm(local_leader, peer_comm,
                                       remote_leader, tag)


def MPI_Intercomm_merge(intercomm, high: bool = False):
    return intercomm.merge(high)


def MPI_Comm_test_inter(comm) -> bool:
    return comm.is_inter


def MPI_Comm_remote_size(comm) -> int:
    return comm.remote_size


def MPI_Comm_remote_group(comm):
    return comm.remote_group_obj()


def MPI_Comm_spawn(command, argv, maxprocs, info=None, root=0,
                   comm=None):
    comm = comm if comm is not None else MPI_COMM_WORLD()
    return comm.spawn(command, argv or (), maxprocs, root)


def MPI_Comm_get_parent():
    return _top.get_parent()


def MPI_Comm_join(fd):
    """ref: ompi/mpi/c/comm_join.c — intercomm from a connected
    socket fd shared with one peer of this universe."""
    from ompi_tpu_torch.comm import dpm as _dpm
    from ompi_tpu_torch.runtime import state as _statemod
    st = _statemod.current()
    return _dpm.comm_join(st.comm_self, fd)


def MPI_Open_port(info=None) -> str:
    return _top.open_port()


def MPI_Close_port(port: str):
    return None


def MPI_Comm_accept(port, info=None, root=0, comm=None):
    comm = comm if comm is not None else MPI_COMM_WORLD()
    return comm.accept(port, root)


def MPI_Comm_connect(port, info=None, root=0, comm=None):
    comm = comm if comm is not None else MPI_COMM_WORLD()
    return comm.connect(port, root)


def MPI_Publish_name(service, info, port):
    _top.publish_name(service, port)


def MPI_Lookup_name(service, info=None) -> str:
    return _top.lookup_name(service)


def MPI_Unpublish_name(service, info, port):
    from ompi_tpu_torch.comm.dpm import unpublish_name as _un
    from ompi_tpu_torch.runtime import state as _st
    _un(_st.current(), service)


# -- pack/unpack (ref: ompi/mpi/c/pack.c, unpack.c) --------------------------
import numpy as _np  # noqa: E402

from ompi_tpu_torch.datatype.convertor import Convertor as _Convertor  # noqa: E402


def _byteview(buf) -> "_np.ndarray":
    a = _np.asarray(buf)
    return a.reshape(-1).view(_np.uint8)


def MPI_Pack(inbuf, incount, datatype, outbuf, outsize, position: int
             ) -> int:
    """Returns the new position (the C in/out position argument)."""
    data = _Convertor(datatype, incount, inbuf).pack()
    if position + len(data) > outsize:
        raise MPIException(_eh_mod.ERR_TRUNCATE,
                           f"pack of {len(data)} bytes at {position} "
                           f"overflows {outsize}-byte buffer")
    _byteview(outbuf)[position:position + len(data)] = \
        _np.frombuffer(data, dtype=_np.uint8)
    return position + len(data)


def MPI_Unpack(inbuf, insize, position: int, outbuf, outcount,
               datatype) -> int:
    nbytes = outcount * datatype.size
    if position + nbytes > insize:
        raise MPIException(_eh_mod.ERR_TRUNCATE)
    data = _byteview(inbuf)[position:position + nbytes].tobytes()
    _Convertor(datatype, outcount, outbuf).unpack(data)
    return position + nbytes


def MPI_Pack_size(incount, datatype, comm=None) -> int:
    return incount * datatype.size


def MPI_Pack_external(datarep, inbuf, incount, datatype, outbuf,
                      outsize, position: int) -> int:
    data = _Convertor(datatype, incount, inbuf, external32=True).pack()
    if position + len(data) > outsize:
        raise MPIException(_eh_mod.ERR_TRUNCATE)
    _byteview(outbuf)[position:position + len(data)] = \
        _np.frombuffer(data, dtype=_np.uint8)
    return position + len(data)


def MPI_Unpack_external(datarep, inbuf, insize, position: int, outbuf,
                        outcount, datatype) -> int:
    conv = _Convertor(datatype, outcount, outbuf, external32=True)
    nbytes = conv.packed_size
    data = _byteview(inbuf)[position:position + nbytes].tobytes()
    conv.unpack(data)
    return position + nbytes


def MPI_Pack_external_size(datarep, incount, datatype) -> int:
    return incount * datatype.size  # external32 packs densely too


# -- environment extras ------------------------------------------------------
MPI_THREAD_SINGLE, MPI_THREAD_FUNNELED, MPI_THREAD_SERIALIZED, \
    MPI_THREAD_MULTIPLE = 0, 1, 2, 3


def MPI_Init_thread(args=None, required: int = MPI_THREAD_MULTIPLE):
    """Returns (comm_world, provided)."""
    return _top.init(), MPI_THREAD_MULTIPLE


def MPI_Query_thread() -> int:
    return MPI_THREAD_MULTIPLE


def MPI_Is_thread_main() -> bool:
    # the thread that initialized MPI is the one owning a ProcState
    from ompi_tpu_torch.runtime import state as _st
    return _st.maybe_current() is not None


def MPI_Get_version():
    return (3, 1)


def MPI_Get_library_version() -> str:
    return f"ompi_tpu_torch {_top.__version__} (PyTorch and CUDA, Open " \
           f"MPI 3.0-compatible surface)"


def MPI_Wtick() -> float:
    import time
    return time.get_clock_info("perf_counter").resolution


def MPI_Pcontrol(level: int, *args) -> None:
    return None  # profiling hook: the spec requires accepting any level


def MPI_Alloc_mem(size: int, info=None):
    return _np.zeros(size, dtype=_np.uint8)


def MPI_Free_mem(base) -> None:
    return None


def MPI_Add_error_class() -> int:
    return _eh_mod.add_error_class()


def MPI_Add_error_code(errorclass: int) -> int:
    return _eh_mod.add_error_code(errorclass)


def MPI_Add_error_string(errorcode: int, string: str) -> None:
    _eh_mod.add_error_string(errorcode, string)


# -- p2p extras --------------------------------------------------------------

def MPI_Sendrecv_replace(buf, count, datatype, dest, stag, source,
                         rtag, comm) -> Status:
    return comm.Sendrecv_replace((buf, count, datatype), dest, stag,
                                 source, rtag)


def MPI_Improbe(source, tag, comm):
    """(flag, message, status) like the C binding."""
    m = comm.state.pml.improbe(source, tag, comm)
    if m is None:
        return False, None, None
    st = Status()
    st.source = m.src
    st.tag = m.tag
    st.count = m.total
    return True, m, st


def MPI_Imrecv(buf, count, datatype, message):
    from ompi_tpu_torch.pml.request import CompletedRequest
    from ompi_tpu_torch.runtime import state as _st
    st = _st.current()
    status = st.pml.mrecv(buf, count, datatype, message,
                          st.comms[message.cid]
                          if hasattr(message, "cid") else st.comm_world)
    r = CompletedRequest(st.progress, status.count)
    r.status = status
    return r


def MPI_Request_get_status(request):
    from ompi_tpu_torch.pml.request import request_get_status
    return request_get_status(request)


def MPI_Testany(requests):
    from ompi_tpu_torch.pml.request import test_any
    return test_any(requests)


def MPI_Testsome(requests):
    from ompi_tpu_torch.pml.request import test_some
    return test_some(requests)


def MPI_Grequest_start(query_fn=None, free_fn=None, cancel_fn=None,
                       extra_state=None):
    from ompi_tpu_torch.pml.request import Grequest
    from ompi_tpu_torch.runtime import state as _st
    return Grequest(_st.current().progress, query_fn, free_fn,
                    cancel_fn, extra_state)


def MPI_Grequest_complete(request) -> None:
    request.complete_now()


def MPI_Test_cancelled(status) -> bool:
    return bool(getattr(status, "cancelled", False))


def MPI_Status_set_cancelled(status, flag: bool) -> None:
    status.cancelled = bool(flag)


def MPI_Status_set_elements(status, datatype, count: int) -> None:
    status.count = count * datatype.size


MPI_Status_set_elements_x = MPI_Status_set_elements


def _elements_per_instance(datatype) -> int:
    n = 0
    for r in datatype.runs:
        n += r.count * r.nblocks
    return max(1, n)


def MPI_Get_elements(status, datatype) -> int:
    """Basic elements received (partial trailing instance counted
    element-wise, ref: ompi/mpi/c/get_elements.c)."""
    if datatype.size == 0:
        return 0
    full, rem = divmod(status.count, datatype.size)
    per = _elements_per_instance(datatype)
    elems = full * per
    if rem:
        # walk the runs of the partial instance in packed order
        for r in datatype.runs:
            take = min(rem, r.packed_bytes)
            elems += take // r.dtype.itemsize
            rem -= take
            if rem <= 0:
                break
    return elems


MPI_Get_elements_x = MPI_Get_elements


# -- groups extras -----------------------------------------------------------

def MPI_Group_range_incl(group, ranges):
    ranks = []
    for first, last, stride in ranges:
        ranks.extend(range(first, last + (1 if stride > 0 else -1),
                           stride))
    return Group([group.ranks[r] for r in ranks])


def MPI_Group_range_excl(group, ranges):
    drop = set()
    for first, last, stride in ranges:
        drop.update(range(first, last + (1 if stride > 0 else -1),
                          stride))
    return Group([g for i, g in enumerate(group.ranks)
                  if i not in drop])


MPI_IDENT, MPI_CONGRUENT, MPI_SIMILAR, MPI_UNEQUAL = 0, 1, 2, 3


def MPI_Group_compare(g1, g2) -> int:
    if g1.ranks == g2.ranks:
        return MPI_IDENT
    if sorted(g1.ranks) == sorted(g2.ranks):
        return MPI_SIMILAR
    return MPI_UNEQUAL


def MPI_Group_free(group) -> None:
    return None


# -- communicator extras -----------------------------------------------------

def MPI_Comm_idup(comm):
    return comm.idup()


def MPI_Comm_dup_with_info(comm, info):
    new = comm.dup()
    new.Set_info(info)
    return new


def MPI_Comm_create_group(comm, group, tag: int = 0):
    return comm.create_group(group, tag)


def MPI_Comm_disconnect(comm) -> None:
    comm.disconnect()


def MPI_Comm_spawn_multiple(count, commands, argvs, maxprocs,
                            infos=None, root=0, comm=None):
    comm = comm if comm is not None else MPI_COMM_WORLD()
    specs = [(commands[i], (argvs[i] if argvs else ()), maxprocs[i])
             for i in range(count)]
    return comm.spawn_multiple(specs, root)


def MPI_Comm_set_name(comm, name: str) -> None:
    comm.Set_name(name)


def MPI_Comm_get_name(comm) -> str:
    return comm.Get_name()


def MPI_Reduce_local(inbuf, inoutbuf, count, datatype, op) -> None:
    """ref: ompi/mpi/c/reduce_local.c — op applied locally."""
    from ompi_tpu_torch.coll.buffers import typed
    a = typed(inbuf, count, datatype).arr
    b = typed(inoutbuf, count, datatype, writable=True)
    b.arr[:] = op.np_fn(a, b.arr)
    b.flush()


def MPI_Op_create(user_fn, commute: bool = True):
    from ompi_tpu_torch.op import op as _opmod
    return _opmod.create(user_fn, commute)


def MPI_Op_free(op) -> None:
    return None


def MPI_Op_commutative(op) -> bool:
    return op.commute


# -- nonblocking collective bindings (coll/nbc) ------------------------------

def MPI_Iallgather(sbuf, scount, sdt, rbuf, rcount, rdt, comm):
    return comm.Iallgather((sbuf, scount, sdt),
                           (rbuf, rcount * comm.size, rdt))


def MPI_Iallgatherv(sbuf, scount, sdt, rbuf, rcounts, displs, rdt,
                    comm):
    return comm.Iallgatherv((sbuf, scount, sdt), (rbuf, 0, rdt),
                            rcounts, displs)


def MPI_Igather(sbuf, scount, sdt, rbuf, rcount, rdt, root, comm):
    return comm.Igather((sbuf, scount, sdt),
                        (rbuf, rcount * comm.size, rdt)
                        if comm.rank == root else None, root)


def MPI_Iscatter(sbuf, scount, sdt, rbuf, rcount, rdt, root, comm):
    return comm.Iscatter((sbuf, scount * comm.size, sdt)
                         if comm.rank == root else None,
                         (rbuf, rcount, rdt), root)


def MPI_Ireduce(sbuf, rbuf, count, datatype, op, root, comm):
    return comm.Ireduce((sbuf, count, datatype),
                        (rbuf, count, datatype)
                        if comm.rank == root else None, op, root)


def MPI_Ialltoallv(sbuf, scounts, sdispls, sdt, rbuf, rcounts,
                   rdispls, rdt, comm):
    return comm.Ialltoallv((sbuf, 0, sdt), scounts, sdispls,
                           (rbuf, 0, rdt), rcounts, rdispls)


def MPI_Ireduce_scatter(sbuf, rbuf, rcounts, datatype, op, comm):
    return comm.Ireduce_scatter((sbuf, sum(rcounts), datatype),
                                (rbuf, rcounts[comm.rank], datatype),
                                rcounts, op)


def MPI_Ireduce_scatter_block(sbuf, rbuf, rcount, datatype, op, comm):
    return comm.Ireduce_scatter_block(
        (sbuf, rcount * comm.size, datatype),
        (rbuf, rcount, datatype), op)


def MPI_Iscan(sbuf, rbuf, count, datatype, op, comm):
    return comm.Iscan((sbuf, count, datatype), (rbuf, count, datatype),
                      op)


def MPI_Iexscan(sbuf, rbuf, count, datatype, op, comm):
    return comm.Iexscan((sbuf, count, datatype),
                        (rbuf, count, datatype), op)


def MPI_Ineighbor_allgather(sbuf, scount, sdt, rbuf, rcount, rdt,
                            comm):
    nin = len(comm.topo.in_neighbors(comm.rank))
    return comm.Ineighbor_allgather((sbuf, scount, sdt),
                                    (rbuf, rcount * nin, rdt))


def MPI_Ineighbor_alltoall(sbuf, scount, sdt, rbuf, rcount, rdt,
                           comm):
    nin = len(comm.topo.in_neighbors(comm.rank))
    nout = len(comm.topo.out_neighbors(comm.rank))
    return comm.Ineighbor_alltoall((sbuf, scount * nout, sdt),
                                   (rbuf, rcount * nin, rdt))


def MPI_Ineighbor_alltoallv(sbuf, scounts, sdispls, sdt, rbuf,
                            rcounts, rdispls, rdt, comm):
    return comm.Ineighbor_alltoallv((sbuf, 0, sdt), scounts, sdispls,
                                    (rbuf, 0, rdt), rcounts, rdispls)


def MPI_Gatherv(sbuf, scount, sdt, rbuf, rcounts, displs, rdt, root,
                comm):
    comm.Gatherv((sbuf, scount, sdt), (rbuf, 0, rdt), rcounts, displs,
                 root)


def MPI_Scatterv(sbuf, scounts, displs, sdt, rbuf, rcount, rdt, root,
                 comm):
    comm.Scatterv((sbuf, 0, sdt), scounts, displs, (rbuf, rcount, rdt),
                  root)


def MPI_Alltoallw(sbuf, scounts, sdispls, stypes, rbuf, rcounts,
                  rdispls, rtypes, comm):
    """Byte-displacement alltoall with per-peer datatypes
    (ref: ompi/mpi/c/alltoallw.c) — direct p2p exchange."""
    sview = _byteview(sbuf)
    rview = _byteview(rbuf)
    pml = comm.state.pml
    reqs = []
    for peer in range(comm.size):
        if rcounts[peer]:
            reqs.append(pml.irecv(rview[rdispls[peer]:], rcounts[peer],
                                  rtypes[peer], peer, -131, comm))
    for peer in range(comm.size):
        if scounts[peer]:
            reqs.append(pml.isend(sview[sdispls[peer]:], scounts[peer],
                                  stypes[peer], peer, -131, comm))
    for r in reqs:
        r.wait()


def MPI_Ialltoallw(sbuf, scounts, sdispls, stypes, rbuf, rcounts,
                   rdispls, rtypes, comm):
    """Nonblocking byte-displacement alltoall with per-peer datatypes
    (ref: ompi/mpi/c/ialltoallw.c): one round of typed isend/irecv
    progressed as an nbc schedule."""
    from ompi_tpu_torch.coll.nbc import NBCRequest, _nbc_tag
    sview = _byteview(sbuf)
    rview = _byteview(rbuf)
    pml = comm.state.pml
    tag = _nbc_tag(comm)  # per-instance: overlapping i-colls never
    thunks = []           # cross-match (the nbc tag discipline)
    for peer in range(comm.size):
        if rcounts[peer]:
            thunks.append(
                lambda p=peer: pml.irecv(rview[rdispls[p]:],
                                         rcounts[p], rtypes[p], p,
                                         tag, comm))
    for peer in range(comm.size):
        if scounts[peer]:
            thunks.append(
                lambda p=peer: pml.isend(sview[sdispls[p]:],
                                         scounts[p], stypes[p], p,
                                         tag, comm))
    return NBCRequest(comm, [thunks])


# -- datatype extras ---------------------------------------------------------
from ompi_tpu_torch.datatype.engine import (  # noqa: E402,F401
    hindexed as MPI_Type_create_hindexed,
    indexed_block as MPI_Type_create_indexed_block,
    hindexed_block as MPI_Type_create_hindexed_block,
    hvector as MPI_Type_create_hvector,
    subarray as MPI_Type_create_subarray,
    darray as MPI_Type_create_darray,
    resized as MPI_Type_create_resized,
    ORDER_C as MPI_ORDER_C, ORDER_FORTRAN as MPI_ORDER_FORTRAN,
    DISTRIBUTE_BLOCK as MPI_DISTRIBUTE_BLOCK,
    DISTRIBUTE_CYCLIC as MPI_DISTRIBUTE_CYCLIC,
    DISTRIBUTE_NONE as MPI_DISTRIBUTE_NONE,
    DISTRIBUTE_DFLT_DARG as MPI_DISTRIBUTE_DFLT_DARG,
)

# deprecated MPI-1 constructor names
MPI_Type_hvector = MPI_Type_create_hvector
MPI_Type_hindexed = MPI_Type_create_hindexed
MPI_Type_struct = MPI_Type_create_struct


def MPI_Type_commit(datatype):
    return datatype  # construction already optimizes/caches the runs


def MPI_Type_free(datatype) -> None:
    return None


def MPI_Type_dup(datatype):
    from ompi_tpu_torch.datatype.engine import dup as _dup
    return _dup(datatype)


def MPI_Type_size(datatype) -> int:
    return datatype.size


MPI_Type_size_x = MPI_Type_size


def MPI_Type_get_extent(datatype):
    return datatype.lb, datatype.extent


MPI_Type_get_extent_x = MPI_Type_get_extent
MPI_Type_extent = MPI_Type_get_extent


def MPI_Type_get_true_extent(datatype):
    return datatype.true_lb, datatype.true_ub - datatype.true_lb


MPI_Type_get_true_extent_x = MPI_Type_get_true_extent


def MPI_Type_lb(datatype) -> int:
    return datatype.lb


def MPI_Type_ub(datatype) -> int:
    return datatype.ub


def MPI_Type_set_name(datatype, name: str) -> None:
    datatype.name = name


def MPI_Type_get_name(datatype) -> str:
    return getattr(datatype, "name", "")


MPI_COMBINER_NAMED = "NAMED"


def MPI_Type_get_envelope(datatype):
    """(combiner, integers, addresses, datatypes) — recorded by every
    constructor (the reference's args-caching,
    ref: ompi/datatype/ompi_datatype_args.c)."""
    env = getattr(datatype, "envelope", None)
    if env is None:
        return (MPI_COMBINER_NAMED, [], [], [])
    return env


def MPI_Type_get_contents(datatype):
    env = getattr(datatype, "envelope", None)
    if env is None or env[0] == MPI_COMBINER_NAMED:
        raise ValueError("predefined datatypes have no contents "
                         "(MPI_ERR_TYPE)")
    return env[1], env[2], env[3]


def _obj_attrs(obj):
    if not hasattr(obj, "attrs"):
        obj.attrs = {}
    return obj


def MPI_Type_set_attr(datatype, keyval, value):
    _attrs_mod.set_attr(_obj_attrs(datatype), keyval, value)


def MPI_Type_get_attr(datatype, keyval):
    return _attrs_mod.get_attr(_obj_attrs(datatype), keyval)


def MPI_Type_delete_attr(datatype, keyval):
    _attrs_mod.delete_attr(_obj_attrs(datatype), keyval)


MPI_TYPECLASS_INTEGER, MPI_TYPECLASS_REAL, MPI_TYPECLASS_COMPLEX = \
    1, 2, 3


def MPI_Type_match_size(typeclass: int, size: int):
    table = {
        (MPI_TYPECLASS_INTEGER, 1): MPI_INT8_T,
        (MPI_TYPECLASS_INTEGER, 2): MPI_INT16_T,
        (MPI_TYPECLASS_INTEGER, 4): MPI_INT32_T,
        (MPI_TYPECLASS_INTEGER, 8): MPI_INT64_T,
        (MPI_TYPECLASS_REAL, 4): MPI_FLOAT,
        (MPI_TYPECLASS_REAL, 8): MPI_DOUBLE,
        (MPI_TYPECLASS_COMPLEX, 8): MPI_C_FLOAT_COMPLEX,
        (MPI_TYPECLASS_COMPLEX, 16): MPI_C_DOUBLE_COMPLEX,
    }
    try:
        return table[(typeclass, size)]
    except KeyError:
        raise ValueError(f"no datatype of class {typeclass} size "
                         f"{size} (MPI_ERR_ARG)") from None


def MPI_Type_create_f90_integer(r: int):
    for dt_, digits in ((MPI_INT8_T, 2), (MPI_INT16_T, 4),
                        (MPI_INT32_T, 9), (MPI_INT64_T, 18)):
        if r <= digits:
            return dt_
    raise ValueError(f"no integer with range {r}")


def MPI_Type_create_f90_real(p: int, r: int):
    if p <= 6 and r <= 37:
        return MPI_FLOAT
    if p <= 15 and r <= 307:
        return MPI_DOUBLE
    raise ValueError(f"no real with precision {p} range {r}")


def MPI_Type_create_f90_complex(p: int, r: int):
    if p <= 6 and r <= 37:
        return MPI_C_FLOAT_COMPLEX
    if p <= 15 and r <= 307:
        return MPI_C_DOUBLE_COMPLEX
    raise ValueError(f"no complex with precision {p} range {r}")


def MPI_Get_address(location) -> int:
    a = _np.asarray(location)
    return a.ctypes.data


MPI_Address = MPI_Get_address


def MPI_Aint_add(base: int, disp: int) -> int:
    return base + disp


def MPI_Aint_diff(a: int, b: int) -> int:
    return a - b


# -- topology extras ---------------------------------------------------------

def MPI_Cartdim_get(comm) -> int:
    return len(comm.topo.dims)


def MPI_Cart_get(comm):
    t = comm.topo
    return list(t.dims), list(t.periods), t.rank_to_coords(comm.rank)


def MPI_Cart_map(comm, ndims, dims, periods) -> int:
    n = 1
    for d in dims:
        n *= d
    return comm.rank if comm.rank < n else MPI_UNDEFINED


def MPI_Graph_create(comm, nnodes, index, edges, reorder=False):
    from ompi_tpu_torch.topo.topo import graph_create
    return graph_create(comm, index, edges, reorder)


def MPI_Graphdims_get(comm):
    t = comm.topo
    return len(t.index), len(t.edges)


def MPI_Graph_get(comm):
    t = comm.topo
    return list(t.index), list(t.edges)


def MPI_Graph_neighbors(comm, rank) -> List[int]:
    return comm.topo.neighbors(rank)


def MPI_Graph_neighbors_count(comm, rank) -> int:
    return len(comm.topo.neighbors(rank))


def MPI_Graph_map(comm, nnodes, index, edges) -> int:
    return comm.rank if comm.rank < nnodes else MPI_UNDEFINED


def MPI_Dist_graph_create_adjacent(comm, sources, sourceweights,
                                   destinations, destweights,
                                   info=None, reorder=False):
    from ompi_tpu_torch.topo.topo import dist_graph_create_adjacent
    return dist_graph_create_adjacent(comm, sources, destinations,
                                      sourceweights, destweights,
                                      reorder)


def MPI_Dist_graph_neighbors(comm):
    t = comm.topo
    return (t.in_neighbors(comm.rank), t.out_neighbors(comm.rank))


def MPI_Dist_graph_neighbors_count(comm):
    t = comm.topo
    return (len(t.in_neighbors(comm.rank)),
            len(t.out_neighbors(comm.rank)),
            getattr(t, "weighted", False))


def MPI_Neighbor_allgatherv(sbuf, scount, sdt, rbuf, rcounts, displs,
                            rdt, comm):
    comm.Neighbor_allgatherv((sbuf, scount, sdt), (rbuf, 0, rdt),
                             rcounts, displs)


def MPI_Neighbor_alltoallv(sbuf, scounts, sdispls, sdt, rbuf, rcounts,
                           rdispls, rdt, comm):
    comm.Neighbor_alltoallv((sbuf, 0, sdt), scounts, sdispls,
                            (rbuf, 0, rdt), rcounts, rdispls)


# -- one-sided extras --------------------------------------------------------

def MPI_Win_allocate(size, disp_unit=1, info=None, comm=None):
    from ompi_tpu_torch.osc import window as _w
    win = _w.allocate(comm, size, disp_unit)
    return win.memory, win


def MPI_Win_free(win) -> None:
    win.free()


def MPI_Win_get_group(win):
    return win.comm.group_obj()


def MPI_Win_set_name(win, name: str) -> None:
    win.name = name


def MPI_Win_get_name(win) -> str:
    return getattr(win, "name", "")


def MPI_Win_set_info(win, info) -> None:
    win.info = info


def MPI_Win_get_info(win):
    from ompi_tpu_torch.info import Info
    return win.info if win.info is not None else Info()


def MPI_Win_lock_all(assert_=0, win=None):
    win.lock_all()


def MPI_Win_unlock_all(win):
    win.unlock_all()


def MPI_Win_flush(rank, win):
    win.flush(rank)


def MPI_Win_flush_all(win):
    win.flush_all()


def MPI_Win_flush_local(rank, win):
    win.flush_local(rank)


def MPI_Win_flush_local_all(win):
    win.flush_all()


def MPI_Win_sync(win):
    win.sync()


def MPI_Win_post(group, assert_=0, win=None):
    win.post(group.ranks)


def MPI_Win_start(group, assert_=0, win=None):
    win.start(group.ranks)


def MPI_Win_complete(win):
    win.complete()


def MPI_Win_wait(win):
    win.wait()


def MPI_Win_test(win) -> bool:
    return win.test()


def MPI_Fetch_and_op(obuf, rbuf, datatype, target, tdisp, op, win):
    win.fetch_and_op(obuf, rbuf, target, tdisp, op)


def MPI_Get_accumulate(obuf, ocount, odt, rbuf, rcount, rdt, target,
                       tdisp, tcount, tdt, op, win):
    win.get_accumulate(obuf, rbuf, target, tdisp, op)


def MPI_Compare_and_swap(obuf, cbuf, rbuf, datatype, target, tdisp,
                         win):
    win.compare_and_swap(cbuf, obuf, rbuf, target, tdisp)


def MPI_Rput(obuf, ocount, odt, target, tdisp, tcount, tdt, win):
    return win.rput(obuf, target, tdisp)


def MPI_Rget(obuf, ocount, odt, target, tdisp, tcount, tdt, win):
    return win.rget(obuf, target, tdisp)


def MPI_Raccumulate(obuf, ocount, odt, target, tdisp, tcount, tdt,
                    op, win):
    return win.raccumulate(obuf, target, tdisp, op)


def MPI_Rget_accumulate(obuf, ocount, odt, rbuf, rcount, rdt, target,
                        tdisp, tcount, tdt, op, win):
    return win.rget_accumulate(obuf, rbuf, target, tdisp, op)


# -- MPI-IO extras -----------------------------------------------------------

def MPI_File_get_amode(fh) -> int:
    return fh.get_amode()


def MPI_File_get_group(fh):
    return fh.get_group()


def MPI_File_get_info(fh):
    return fh.get_info()


def MPI_File_set_info(fh, info) -> None:
    fh.set_info(info)


def MPI_File_get_byte_offset(fh, offset) -> int:
    return fh.get_byte_offset(offset)


def MPI_File_get_type_extent(fh, datatype) -> int:
    return fh.get_type_extent(datatype)


def MPI_File_get_atomicity(fh) -> bool:
    return fh.get_atomicity()


def MPI_File_set_atomicity(fh, flag: bool) -> None:
    fh.set_atomicity(flag)


def MPI_File_preallocate(fh, size) -> None:
    fh.preallocate(size)


def MPI_File_get_view(fh):
    return fh.get_view()


def MPI_File_seek_shared(fh, offset, whence=0) -> None:  # MPI_SEEK_SET
    fh.seek_shared(offset, whence)


def MPI_File_get_position_shared(fh) -> int:
    return fh.get_position_shared()


def MPI_File_iread_all(fh, buf, count, datatype):
    return fh.iread_all((buf, count, datatype))


def MPI_File_iwrite_all(fh, buf, count, datatype):
    return fh.iwrite_all((buf, count, datatype))


def MPI_File_iread_at_all(fh, offset, buf, count, datatype):
    return fh.iread_at_all(offset, (buf, count, datatype))


def MPI_File_iwrite_at_all(fh, offset, buf, count, datatype):
    return fh.iwrite_at_all(offset, (buf, count, datatype))


def MPI_File_iread_shared(fh, buf, count, datatype):
    return fh.iread_shared((buf, count, datatype))


def MPI_File_iwrite_shared(fh, buf, count, datatype):
    return fh.iwrite_shared((buf, count, datatype))


def MPI_File_read_all_begin(fh, buf, count, datatype) -> None:
    fh.read_all_begin((buf, count, datatype))


def MPI_File_read_all_end(fh, buf=None) -> Status:
    return fh.read_all_end(buf)


def MPI_File_write_all_begin(fh, buf, count, datatype) -> None:
    fh.write_all_begin((buf, count, datatype))


def MPI_File_write_all_end(fh, buf=None) -> Status:
    return fh.write_all_end(buf)


def MPI_File_read_at_all_begin(fh, offset, buf, count, datatype):
    fh.read_at_all_begin(offset, (buf, count, datatype))


def MPI_File_read_at_all_end(fh, buf=None) -> Status:
    return fh.read_at_all_end(buf)


def MPI_File_write_at_all_begin(fh, offset, buf, count, datatype):
    fh.write_at_all_begin(offset, (buf, count, datatype))


def MPI_File_write_at_all_end(fh, buf=None) -> Status:
    return fh.write_at_all_end(buf)


def MPI_File_read_ordered_begin(fh, buf, count, datatype) -> None:
    fh.read_ordered_begin((buf, count, datatype))


def MPI_File_read_ordered_end(fh, buf=None) -> Status:
    return fh.read_ordered_end(buf)


def MPI_File_write_ordered_begin(fh, buf, count, datatype) -> None:
    fh.write_ordered_begin((buf, count, datatype))


def MPI_File_write_ordered_end(fh, buf=None) -> Status:
    return fh.write_ordered_end(buf)


# deprecated MPI-1 errhandler names (ref: ompi/mpi/c/errhandler_set.c)
MPI_Errhandler_create = MPI_Comm_create_errhandler
MPI_Errhandler_set = MPI_Comm_set_errhandler
MPI_Errhandler_get = MPI_Comm_get_errhandler


def MPI_Info_get_valuelen(info, key: str):
    flag, val = info.get(key)
    return flag, (len(val) if flag else 0)


def MPI_Rsend_init(buf, count, datatype, dest, tag, comm):
    # ready-mode persistent send ≡ standard persistent send under ob1
    return MPI_Send_init(buf, count, datatype, dest, tag, comm)


def MPI_Igatherv(sbuf, scount, sdt, rbuf, rcounts, displs, rdt, root,
                 comm):
    return comm.Igatherv((sbuf, scount, sdt), (rbuf, 0, rdt), rcounts,
                         displs, root)


def MPI_Iscatterv(sbuf, scounts, displs, sdt, rbuf, rcount, rdt, root,
                  comm):
    return comm.Iscatterv((sbuf, 0, sdt), scounts, displs,
                          (rbuf, rcount, rdt), root)


def MPI_Ineighbor_allgatherv(sbuf, scount, sdt, rbuf, rcounts, displs,
                             rdt, comm):
    return comm.Ineighbor_allgatherv((sbuf, scount, sdt),
                                     (rbuf, 0, rdt), rcounts, displs)


def MPI_Neighbor_alltoallw(sbuf, scounts, sdispls, stypes, rbuf,
                           rcounts, rdispls, rtypes, comm):
    """Per-neighbor datatypes with byte displacements
    (ref: ompi/mpi/c/neighbor_alltoallw.c)."""
    topo = comm.topo
    srcs = topo.in_neighbors(comm.rank)
    dsts = topo.out_neighbors(comm.rank)
    sview = _byteview(sbuf)
    rview = _byteview(rbuf)
    pml = comm.state.pml
    reqs = []
    for i, src in enumerate(srcs):
        if rcounts[i]:
            reqs.append(pml.irecv(rview[rdispls[i]:], rcounts[i],
                                  rtypes[i], src, -132, comm))
    for i, dst in enumerate(dsts):
        if scounts[i]:
            reqs.append(pml.isend(sview[sdispls[i]:], scounts[i],
                                  stypes[i], dst, -132, comm))
    for r in reqs:
        r.wait()


def MPI_Ineighbor_alltoallw(sbuf, scounts, sdispls, stypes, rbuf,
                            rcounts, rdispls, rtypes, comm):
    """Nonblocking per-neighbor-datatype exchange
    (ref: ompi/mpi/c/ineighbor_alltoallw.c)."""
    from ompi_tpu_torch.coll.nbc import NBCRequest, _nbc_tag
    topo = comm.topo
    srcs = topo.in_neighbors(comm.rank)
    dsts = topo.out_neighbors(comm.rank)
    sview = _byteview(sbuf)
    rview = _byteview(rbuf)
    pml = comm.state.pml
    tag = _nbc_tag(comm)
    thunks = []
    for i, src in enumerate(srcs):
        if rcounts[i]:
            thunks.append(
                lambda j=i, s=src: pml.irecv(rview[rdispls[j]:],
                                             rcounts[j], rtypes[j],
                                             s, tag, comm))
    for i, dst in enumerate(dsts):
        if scounts[i]:
            thunks.append(
                lambda j=i, d=dst: pml.isend(sview[sdispls[j]:],
                                             scounts[j], stypes[j],
                                             d, tag, comm))
    return NBCRequest(comm, [thunks])


def MPI_Register_datarep(datarep, read_conversion_fn=None,
                         write_conversion_fn=None,
                         dtype_file_extent_fn=None,
                         extra_state=None):
    """Register a user data representation for file views
    (ref: ompi/mpi/c/register_datarep.c).  Conversion callables take
    (raw_bytes, datatype, count, extra_state) and return converted
    bytes of equal length."""
    from ompi_tpu_torch.io.file import register_datarep
    register_datarep(datarep, read_conversion_fn,
                     write_conversion_fn, dtype_file_extent_fn,
                     extra_state)


def MPI_Dist_graph_create(comm, n, sources, degrees, destinations,
                          weights=None, info=None, reorder=False):
    from ompi_tpu_torch.topo.topo import dist_graph_create
    return dist_graph_create(comm, sources, degrees, destinations,
                             weights, reorder)


def MPI_Win_create_dynamic(info=None, comm=None):
    from ompi_tpu_torch.osc import window as _w
    return _w.create_dynamic(comm, info)


def MPI_Win_attach(win, base, size=None) -> None:
    win.attach(_np.asarray(base))


def MPI_Win_detach(win, base) -> None:
    win.detach(_np.asarray(base))


def MPI_Win_allocate_shared(size, disp_unit=1, info=None, comm=None):
    from ompi_tpu_torch.osc import window as _w
    win = _w.allocate_shared(comm, size, disp_unit)
    return win.memory, win


def MPI_Win_shared_query(win, rank):
    from ompi_tpu_torch.osc import window as _w
    return _w.shared_query(win, rank)


# -- handle conversion (ref: ompi/mpi/c/*_f2c.c, *_c2f.c): handles are
# Python objects; the Fortran-integer form is a process-local registry
# index, a REAL translation (not an identity stub) -------------------------
_f_handles: List = []
_f_ids: dict = {}


def _c2f(obj) -> int:
    key = id(obj)
    idx = _f_ids.get(key)
    if idx is None:
        idx = len(_f_handles)
        _f_handles.append(obj)
        _f_ids[key] = idx
    return idx


def _f2c(idx: int):
    if not 0 <= idx < len(_f_handles):
        raise ValueError(f"invalid Fortran handle {idx} (MPI_ERR_ARG)")
    return _f_handles[idx]


def MPI_Comm_c2f(h) -> int:
    """ref: ompi/mpi/c/comm_c2f.c"""
    return _c2f(h)


def MPI_Comm_f2c(idx: int):
    """ref: ompi/mpi/c/comm_f2c.c"""
    return _f2c(idx)


def MPI_Group_c2f(h) -> int:
    """ref: ompi/mpi/c/group_c2f.c"""
    return _c2f(h)


def MPI_Group_f2c(idx: int):
    """ref: ompi/mpi/c/group_f2c.c"""
    return _f2c(idx)


def MPI_Op_c2f(h) -> int:
    """ref: ompi/mpi/c/op_c2f.c"""
    return _c2f(h)


def MPI_Op_f2c(idx: int):
    """ref: ompi/mpi/c/op_f2c.c"""
    return _f2c(idx)


def MPI_Info_c2f(h) -> int:
    """ref: ompi/mpi/c/info_c2f.c"""
    return _c2f(h)


def MPI_Info_f2c(idx: int):
    """ref: ompi/mpi/c/info_f2c.c"""
    return _f2c(idx)


def MPI_Win_c2f(h) -> int:
    """ref: ompi/mpi/c/win_c2f.c"""
    return _c2f(h)


def MPI_Win_f2c(idx: int):
    """ref: ompi/mpi/c/win_f2c.c"""
    return _f2c(idx)


def MPI_File_c2f(h) -> int:
    """ref: ompi/mpi/c/file_c2f.c"""
    return _c2f(h)


def MPI_File_f2c(idx: int):
    """ref: ompi/mpi/c/file_f2c.c"""
    return _f2c(idx)


def MPI_Errhandler_c2f(h) -> int:
    """ref: ompi/mpi/c/errhandler_c2f.c"""
    return _c2f(h)


def MPI_Errhandler_f2c(idx: int):
    """ref: ompi/mpi/c/errhandler_f2c.c"""
    return _f2c(idx)


def MPI_Request_c2f(h) -> int:
    """ref: ompi/mpi/c/request_c2f.c"""
    return _c2f(h)


def MPI_Request_f2c(idx: int):
    """ref: ompi/mpi/c/request_f2c.c"""
    return _f2c(idx)


def MPI_Message_c2f(h) -> int:
    """ref: ompi/mpi/c/message_c2f.c"""
    return _c2f(h)


def MPI_Message_f2c(idx: int):
    """ref: ompi/mpi/c/message_f2c.c"""
    return _f2c(idx)


def MPI_Type_c2f(h) -> int:
    """ref: ompi/mpi/c/type_c2f.c"""
    return _c2f(h)


def MPI_Type_f2c(idx: int):
    """ref: ompi/mpi/c/type_f2c.c"""
    return _f2c(idx)


def MPI_Status_c2f(status) -> List[int]:
    return [status.source, status.tag,
            getattr(status, "error", 0), status.count]


def MPI_Status_f2c(f_status) -> Status:
    st = Status()
    st.source, st.tag = f_status[0], f_status[1]
    st.error = f_status[2]
    st.count = f_status[3]
    return st


# -- PMPI aliases (profiling layer, ref: ompi/mpi/c/init.c:35-37) -----------

_mod = _sys.modules[__name__]
for _name in list(vars(_mod)):
    if _name.startswith("MPI_") and callable(getattr(_mod, _name)):
        setattr(_mod, "P" + _name, getattr(_mod, _name))
del _mod, _name
