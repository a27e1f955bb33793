"""MPI-IO file objects (io/ompio analog).

Port of the reference's io/file.py, a re-design of ompi/mca/io/ompio
(ref: io_ompio_file_open.c, io_ompio_file_read.c/write.c; the
sub-framework split: fs = filesystem open/size ops, fbtl = individual
byte transfer [posix pread/pwrite here], fcoll = collective algorithms
[ompi_tpu_torch.io.fcoll two-phase], sharedfp = shared file pointer
[an osc fetch_and_op counter owned by rank 0, the sharedfp/sm idea
with the window replacing the shared-memory segment]).

Positions are maintained in etype units like MPI file pointers;
views map them to file bytes (ompi_tpu_torch.io.view).  Data moves
through the same TypedBuf packing the host collectives use, so derived
memory datatypes and derived filetypes compose.  Buffers are numpy
arrays, as on the port's host path; a tensor's bytes reach a file
through a host copy its caller makes (cr/ckpt.py drains card tensors
into pinned stages first).
"""

from __future__ import annotations

import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ompi_tpu_torch.coll.buffers import TypedBuf, typed
from ompi_tpu_torch.datatype import engine as dtmod
from ompi_tpu_torch.io.view import FileView
from ompi_tpu_torch.pml.request import CompletedRequest, Status

# MPI open-mode bits (mpi.h values)
MODE_CREATE = 1
MODE_RDONLY = 2
MODE_WRONLY = 4
MODE_RDWR = 8
MODE_DELETE_ON_CLOSE = 16
MODE_UNIQUE_OPEN = 32
MODE_EXCL = 64
MODE_APPEND = 128
MODE_SEQUENTIAL = 256

SEEK_SET = 0
SEEK_CUR = 1
SEEK_END = 2


# user data representations (MPI_Register_datarep, ref:
# ompi/mpi/c/register_datarep.c + ompi/mca/io/base registration):
# name -> (read_fn, write_fn, extent_fn, extra_state).  Conversion
# functions take (filebytes_or_userbytes, datatype, count, extra)
# and return converted bytes of the SAME length (length-changing
# representations are out of scope, as in the reference's ompio,
# which rejects datareps it cannot serve).
_datareps: dict = {}


def register_datarep(name: str, read_fn=None, write_fn=None,
                     extent_fn=None, extra_state=None) -> None:
    if name in ("native", "external32", "internal") \
            or name in _datareps:
        raise ValueError(
            f"datarep {name!r} already defined (MPI_ERR_DUP_DATAREP)")
    _datareps[name] = (read_fn, write_fn, extent_fn, extra_state)


def _posix_flags(amode: int) -> int:
    if amode & MODE_RDWR:
        flags = os.O_RDWR
    elif amode & MODE_WRONLY:
        flags = os.O_WRONLY
    else:
        flags = os.O_RDONLY
    if amode & MODE_CREATE:
        flags |= os.O_CREAT
    if amode & MODE_EXCL:
        flags |= os.O_EXCL
    # MODE_APPEND is NOT mapped to O_APPEND: Linux pwrite ignores its
    # offset on O_APPEND fds; MPI's append semantics are "file
    # pointers start at end-of-file", handled in File.__init__
    return flags


class File:
    """One collectively-opened file (MPI_File)."""

    def __init__(self, comm, filename: str, amode: int,
                 info=None) -> None:
        from ompi_tpu_torch import errhandler as _eh
        self.comm = comm
        self.filename = filename
        self.amode = amode
        # accepts an ompi_tpu_torch.info.Info or a plain mapping
        self.info = dict(info.items()) if hasattr(info, "items") \
            else dict(info or {})
        self.errhandler = _eh.ERRORS_RETURN
        self.attrs = {}
        self._datarep = "native"
        self.state = comm.state
        self._lock = threading.Lock()
        # fs: open is collective; every rank opens its own descriptor
        # (ufs model), errors surfaced on all ranks via an agreement
        err = 0
        self.fd = -1
        try:
            self.fd = os.open(filename, _posix_flags(amode), 0o644)
        except OSError:
            err = 1
        errs = np.array([err], dtype=np.int64)
        tot = np.zeros(1, dtype=np.int64)
        from ompi_tpu_torch.op import op as opmod
        comm.Allreduce(errs, tot, opmod.SUM)
        if tot[0]:
            if self.fd >= 0:
                os.close(self.fd)
            raise OSError(
                f"collective open of {filename!r} failed on "
                f"{int(tot[0])} rank(s) (MPI_ERR_IO)")
        self.view = FileView()
        self.pos = 0            # individual fp, etype units
        self._closed = False
        # sharedfp: rank 0 exposes the counter through a window on a
        # dup (internal traffic must not alias user comm traffic).
        # The ROMIO-style info hint "sharedfp" => "false" skips the
        # sub-framework entirely: no dup, no window, and no per-sweep
        # AM polling for the file's whole lifetime — callers that
        # never touch shared file pointers (the checkpoint engine)
        # keep the hot path clean.
        self._sp_comm = None
        self._sp_win = None
        self._sp_mem = np.zeros(1, dtype=np.int64)
        if str(self.info.get("sharedfp", "true")).lower() not in (
                "false", "0", "disable"):
            from ompi_tpu_torch.osc import window as oscmod
            self._sp_comm = comm.dup(name=f"file-{id(self):x}")
            self._sp_win = oscmod.create(self._sp_comm,
                                         self._sp_mem if comm.rank == 0
                                         else np.zeros(0,
                                                       dtype=np.int64))
        if amode & MODE_APPEND:
            # MPI_MODE_APPEND: individual + shared fps start at EOF
            self.pos = self._size_etypes()
            if comm.rank == 0:
                self._sp_mem[0] = self.pos
            comm.Barrier()

    # -- fs ops ----------------------------------------------------------
    def close(self) -> None:
        if self._closed:
            return
        self.comm.Barrier()
        if self._sp_win is not None:
            self._sp_win.free()
            self._sp_comm.free()
        os.close(self.fd)
        if self.amode & MODE_DELETE_ON_CLOSE and self.comm.rank == 0:
            try:
                os.unlink(self.filename)
            except OSError:
                pass
        self._closed = True

    def ft_abandon(self) -> None:
        """LOCAL close for fault paths: the job just lost ranks, so
        ``close``'s barrier and the sharedfp window's free handshake
        are not an option.  Drops the fd and abandons the window (its
        wildcard receive must not survive into the recovered epoch —
        see Window.abandon); the dup'd comm is left for GC."""
        if self._closed:
            return
        self._closed = True
        if self._sp_win is not None:
            self._sp_win.abandon()
        try:
            os.close(self.fd)
        except OSError:
            pass

    def get_size(self) -> int:
        return os.fstat(self.fd).st_size

    def get_amode(self) -> int:
        return self.amode

    def get_group(self):
        return self.comm.group_obj()

    def get_info(self):
        from ompi_tpu_torch.info import Info
        out = Info()
        for k, v in self.info.items():
            out.set(k, v)
        return out

    def set_info(self, info) -> None:
        items = info.items() if hasattr(info, "items") else \
            dict(info or {}).items()
        for k, v in items:
            self.info[k] = v

    def get_byte_offset(self, offset: int) -> int:
        """MPI_File_get_byte_offset: view-relative etype offset ->
        absolute byte offset."""
        segs = self.view.map_bytes(offset, max(1, self.view.etype.size))
        return segs[0][0] if segs else self.view.disp

    def get_type_extent(self, datatype) -> int:
        return datatype.extent

    def get_atomicity(self) -> bool:
        return False  # per-op posix pread/pwrite; no cross-rank atomic mode

    def set_atomicity(self, flag: bool) -> None:
        if flag:
            raise ValueError(
                "atomic mode is not supported (MPI_ERR_UNSUPPORTED_"
                "OPERATION)")

    def set_size(self, size: int) -> None:
        os.ftruncate(self.fd, size)

    def preallocate(self, size: int) -> None:
        if self.get_size() < size:
            os.ftruncate(self.fd, size)

    def sync(self) -> None:
        os.fsync(self.fd)

    # -- views -----------------------------------------------------------
    def set_view(self, disp: int = 0, etype=None, filetype=None,
                 datarep: str = "native") -> None:
        if datarep not in ("native", "external32") \
                and datarep not in _datareps:
            raise ValueError(f"unsupported datarep {datarep!r}")
        self.view = FileView(disp, etype, filetype)
        self.pos = 0
        self._datarep = datarep

    def get_view(self):
        return (self.view.disp, self.view.etype, self.view.filetype)

    # -- individual fp ---------------------------------------------------
    def seek(self, offset: int, whence: int = SEEK_SET) -> None:
        if whence == SEEK_SET:
            new = offset
        elif whence == SEEK_CUR:
            new = self.pos + offset
        else:
            new = self._size_etypes() + offset
        if new < 0:  # validate before mutating: pos stays usable
            raise ValueError("seek before file start (MPI_ERR_ARG)")
        self.pos = new

    def get_position(self) -> int:
        return self.pos

    def _size_etypes(self) -> int:
        return self.get_size() // max(1, self.view.etype.size)

    # -- fbtl: segment IO ------------------------------------------------
    def _pread_segs(self, segs: List[Tuple[int, int]]) -> bytes:
        data, _ = self._pread_segs_counted(segs)
        return data

    def _pread_segs_counted(self, segs: List[Tuple[int, int]]
                            ) -> Tuple[bytes, int]:
        """(zero-padded data, actually-read byte count) — the count is
        what MPI_Get_count must report so EOF is detectable."""
        out = bytearray()
        actual = 0
        for off, ln in segs:
            chunk = os.pread(self.fd, ln, off)
            actual += len(chunk)
            if len(chunk) < ln:           # short read past EOF: zeros
                chunk = chunk + b"\0" * (ln - len(chunk))
            out += chunk
        return bytes(out), actual

    def _pwrite_segs(self, segs: List[Tuple[int, int]],
                     data: memoryview) -> int:
        o = 0
        for off, ln in segs:
            os.pwrite(self.fd, data[o:o + ln], off)
            o += ln
        return o

    # -- individual read/write -------------------------------------------
    def _spec(self, spec):
        from ompi_tpu_torch.comm.communicator import Communicator
        return Communicator._spec(spec)

    def read_at(self, offset: int, spec) -> Status:
        buf, count, dt = self._spec(spec)
        tb = typed(buf, count, dt, writable=True)
        segs = self.view.map_bytes(offset, tb.arr.nbytes)
        data, actual = self._pread_segs_counted(segs)
        rep = _datareps.get(self._datarep)
        if rep is not None and rep[0] is not None:
            before = len(data)
            data = rep[0](bytes(data), dt, count, rep[3])
            if len(data) != before:
                raise ValueError(
                    f"datarep {self._datarep!r} read conversion "
                    "changed the byte length (unsupported)")
        tb.arr.view(np.uint8)[:len(data)] = np.frombuffer(
            data, dtype=np.uint8)
        tb.flush()
        st = Status()
        st.count = actual
        return st

    def write_at(self, offset: int, spec) -> Status:
        buf, count, dt = self._spec(spec)
        tb = typed(buf, count, dt)
        raw = tb.arr.view(np.uint8).data
        rep = _datareps.get(self._datarep)
        if rep is not None and rep[1] is not None:
            conv = rep[1](bytes(raw), dt, count, rep[3])
            if len(conv) != len(raw):
                raise ValueError(
                    f"datarep {self._datarep!r} write conversion "
                    "changed the byte length (unsupported)")
            raw = memoryview(conv)
        segs = self.view.map_bytes(offset, tb.arr.nbytes)
        n = self._pwrite_segs(segs, raw)
        st = Status()
        st.count = n
        return st

    def read(self, spec) -> Status:
        st = self.read_at(self.pos, spec)
        self.pos += st.count // max(1, self.view.etype.size)
        return st

    def write(self, spec) -> Status:
        st = self.write_at(self.pos, spec)
        self.pos += st.count // max(1, self.view.etype.size)
        return st

    # nonblocking: the posix fbtl completes synchronously (the
    # reference's fbtl/posix without aio does the same under the
    # request veneer)
    def iread(self, spec):
        st = self.read(spec)
        return _done_req(self.comm, st)

    def iwrite(self, spec):
        st = self.write(spec)
        return _done_req(self.comm, st)

    def iread_at(self, offset: int, spec):
        return _done_req(self.comm, self.read_at(offset, spec))

    def iwrite_at(self, offset: int, spec):
        return _done_req(self.comm, self.write_at(offset, spec))

    # -- shared fp --------------------------------------------------------
    def _sp_required(self) -> None:
        if self._sp_win is None:
            raise RuntimeError(
                "shared file pointers were disabled by the "
                "'sharedfp' info hint at open (MPI_ERR_UNSUPPORTED_"
                "OPERATION)")

    def _shared_fetch_add(self, delta: int) -> int:
        from ompi_tpu_torch.op import op as opmod
        from ompi_tpu_torch.osc.window import LOCK_SHARED
        self._sp_required()
        result = np.zeros(1, dtype=np.int64)
        self._sp_win.lock(0, LOCK_SHARED)
        self._sp_win.fetch_and_op(delta, result, 0, 0, opmod.SUM)
        self._sp_win.unlock(0)
        return int(result[0])

    def seek_shared(self, offset: int, whence: int = SEEK_SET) -> None:
        """Collective; all ranks must give the same offset."""
        from ompi_tpu_torch.op import op as opmod
        from ompi_tpu_torch.osc.window import LOCK_EXCLUSIVE
        self._sp_required()
        self.comm.Barrier()
        if self.comm.rank == 0:
            if whence == SEEK_CUR:
                offset += int(self._sp_mem[0])
            elif whence == SEEK_END:
                offset += self._size_etypes()
            result = np.zeros(1, dtype=np.int64)
            self._sp_win.lock(0, LOCK_EXCLUSIVE)
            self._sp_win.fetch_and_op(offset, result, 0, 0, opmod.REPLACE)
            self._sp_win.unlock(0)
        self.comm.Barrier()

    def get_position_shared(self) -> int:
        return self._shared_fetch_add(0)

    def read_shared(self, spec) -> Status:
        buf, count, dt = self._spec(spec)
        nbytes = count * dt.size
        pos = self._shared_fetch_add(
            nbytes // max(1, self.view.etype.size))
        return self.read_at(pos, spec)

    def write_shared(self, spec) -> Status:
        buf, count, dt = self._spec(spec)
        nbytes = count * dt.size
        pos = self._shared_fetch_add(
            nbytes // max(1, self.view.etype.size))
        return self.write_at(pos, spec)

    # ordered = shared-fp collective: ranks get rank-ordered slots via
    # exscan of their sizes from the current shared position
    # (ref: sharedfp read_ordered semantics)
    def _ordered_pos(self, nbytes: int) -> int:
        from ompi_tpu_torch.op import op as opmod
        self._sp_required()  # symmetric raise BEFORE any collective
        mine = np.array([nbytes // max(1, self.view.etype.size)],
                        dtype=np.int64)
        pref = np.zeros(1, dtype=np.int64)
        self.comm.Exscan(mine, pref, opmod.SUM)
        total = np.zeros(1, dtype=np.int64)
        self.comm.Allreduce(mine, total, opmod.SUM)
        if self.comm.rank == 0:
            pref[0] = 0
        base = 0
        if self.comm.rank == 0:
            base = self._shared_fetch_add(int(total[0]))
        b = np.array([base], dtype=np.int64)
        self.comm.Bcast(b, root=0)
        return int(b[0] + pref[0])

    def read_ordered(self, spec) -> Status:
        buf, count, dt = self._spec(spec)
        pos = self._ordered_pos(count * dt.size)
        return self.read_at(pos, spec)

    def write_ordered(self, spec) -> Status:
        buf, count, dt = self._spec(spec)
        pos = self._ordered_pos(count * dt.size)
        return self.write_at(pos, spec)

    # -- collectives (fcoll two-phase) -----------------------------------
    def read_at_all(self, offset: int, spec) -> Status:
        from ompi_tpu_torch.io import fcoll
        return fcoll.read_all(self, offset, spec)

    def write_at_all(self, offset: int, spec) -> Status:
        from ompi_tpu_torch.io import fcoll
        return fcoll.write_all(self, offset, spec)

    def read_all(self, spec) -> Status:
        st = self.read_at_all(self.pos, spec)
        self.pos += st.count // max(1, self.view.etype.size)
        return st

    def write_all(self, spec) -> Status:
        st = self.write_at_all(self.pos, spec)
        self.pos += st.count // max(1, self.view.etype.size)
        return st

    # -- nonblocking collectives + shared-fp -------------------------
    # (the fcoll exchange is synchronous inside, like romio's
    # deferred-open collectives at this altitude; the request is born
    # complete)
    def iread_all(self, spec):
        return _done_req(self.comm, self.read_all(spec))

    def iwrite_all(self, spec):
        return _done_req(self.comm, self.write_all(spec))

    def iread_at_all(self, offset: int, spec):
        return _done_req(self.comm, self.read_at_all(offset, spec))

    def iwrite_at_all(self, offset: int, spec):
        return _done_req(self.comm, self.write_at_all(offset, spec))

    def iread_shared(self, spec):
        return _done_req(self.comm, self.read_shared(spec))

    def iwrite_shared(self, spec):
        return _done_req(self.comm, self.write_shared(spec))

    # -- split-phase collectives (ref: ompi/mpi/c/file_read_all_begin.c
    # family): begin runs the collective, end returns its status; at
    # most one split collective may be active per file handle (the
    # MPI rule), which we enforce.
    def _begin(self, kind: str, st: Status) -> None:
        if getattr(self, "_split", None) is not None:
            raise RuntimeError(
                "a split collective is already active on this file "
                "(MPI_ERR_OTHER)")
        self._split = (kind, st)

    def _end(self, kind: str) -> Status:
        cur = getattr(self, "_split", None)
        if cur is None or cur[0] != kind:
            raise RuntimeError(
                f"no matching {kind}_begin active (MPI_ERR_OTHER)")
        self._split = None
        return cur[1]

    def read_all_begin(self, spec) -> None:
        self._begin("read_all", self.read_all(spec))

    def read_all_end(self, buf=None) -> Status:
        return self._end("read_all")

    def write_all_begin(self, spec) -> None:
        self._begin("write_all", self.write_all(spec))

    def write_all_end(self, buf=None) -> Status:
        return self._end("write_all")

    def read_at_all_begin(self, offset: int, spec) -> None:
        self._begin("read_at_all", self.read_at_all(offset, spec))

    def read_at_all_end(self, buf=None) -> Status:
        return self._end("read_at_all")

    def write_at_all_begin(self, offset: int, spec) -> None:
        self._begin("write_at_all", self.write_at_all(offset, spec))

    def write_at_all_end(self, buf=None) -> Status:
        return self._end("write_at_all")

    def read_ordered_begin(self, spec) -> None:
        self._begin("read_ordered", self.read_ordered(spec))

    def read_ordered_end(self, buf=None) -> Status:
        return self._end("read_ordered")

    def write_ordered_begin(self, spec) -> None:
        self._begin("write_ordered", self.write_ordered(spec))

    def write_ordered_end(self, buf=None) -> Status:
        return self._end("write_ordered")


def _done_req(comm, st: Status) -> CompletedRequest:
    r = CompletedRequest(comm.state.progress, st.count)
    r.status = st
    return r


def open(comm, filename: str, amode: int = MODE_RDONLY,
         info=None) -> File:  # noqa: A001 (MPI_File_open)
    return File(comm, filename, amode, info)


def delete(filename: str) -> None:
    os.unlink(filename)


from ompi_tpu_torch import errhandler as _eh_mod  # noqa: E402

_eh_mod.attach_api(File)
