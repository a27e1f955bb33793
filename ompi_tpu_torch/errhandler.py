"""Error handlers + MPI error classes: the part the RMA windows use.

Port of the reference package's errhandler module (ref:
ompi/errhandler/errhandler.h — per-object handler dispatch; error
classes ref: ompi/include/mpi.h.in and ompi/errhandler/errcode.c).

Python surface semantics: raising an exception IS the error-return
mechanism, so the default handler is ERRORS_RETURN (the raised
MPIException carries the error class; this is the same stance mpi4py
takes).  Installing ERRORS_ARE_FATAL restores the reference's default
C behavior — any error on the object aborts the job via the rte.
User handlers are callables fn(obj, errorcode) invoked before the
exception propagates.
"""

from __future__ import annotations

from typing import Callable, Optional

# -- error classes (values match the reference's mpi.h) ---------------------
SUCCESS = 0
ERR_BUFFER = 1
ERR_COUNT = 2
ERR_TYPE = 3
ERR_TAG = 4
ERR_COMM = 5
ERR_RANK = 6
ERR_REQUEST = 7
ERR_ROOT = 8
ERR_GROUP = 9
ERR_OP = 10
ERR_TOPOLOGY = 11
ERR_DIMS = 12
ERR_ARG = 13
ERR_UNKNOWN = 14
ERR_TRUNCATE = 15
ERR_OTHER = 16
ERR_INTERN = 17
ERR_IN_STATUS = 18
ERR_PENDING = 19
ERR_ACCESS = 20
ERR_AMODE = 21
ERR_BAD_FILE = 23
ERR_FILE_EXISTS = 25
ERR_FILE_IN_USE = 26
ERR_FILE = 27
ERR_INFO_KEY = 29
ERR_INFO_NOKEY = 31
ERR_INFO_VALUE = 30
ERR_INFO = 28
ERR_IO = 32
ERR_KEYVAL = 33
ERR_NAME = 36
ERR_NO_MEM = 37
ERR_NOT_SAME = 38
ERR_NO_SUCH_FILE = 41
ERR_PORT = 42
ERR_SERVICE = 44
ERR_SIZE = 45
ERR_SPAWN = 46
ERR_UNSUPPORTED_DATAREP = 47
ERR_UNSUPPORTED_OPERATION = 48
ERR_WIN = 49
# ULFM / MPI-4 fault-tolerance classes (values match the reference's
# MPIX_ERR_* block in ompi/include/mpi.h.in)
ERR_PROC_FAILED = 75
ERR_PROC_FAILED_PENDING = 76
ERR_REVOKED = 77
ERR_LASTCODE = 93

_CLASS_NAMES = {
    v: k for k, v in list(globals().items())
    if k.startswith("ERR_") or k == "SUCCESS"
}


def error_string(code: int) -> str:
    """MPI_Error_string analog (ref: ompi/errhandler/errcode.c)."""
    return f"MPI_{_CLASS_NAMES.get(code, 'ERR_UNKNOWN')}"


class MPIException(Exception):
    """An MPI error carrying its error class (the Python analog of a
    nonzero return code from a C binding)."""

    def __init__(self, code: int, msg: str = "") -> None:
        super().__init__(msg or error_string(code))
        self.code = code

    @property
    def error_class(self) -> int:
        return self.code


def classify(exc: BaseException) -> int:
    """Map a raised exception to an MPI error class."""
    if isinstance(exc, MPIException):
        return exc.code
    text = str(exc)
    for marker, code in (
            ("MPI_ERR_RANK", ERR_RANK), ("MPI_ERR_TAG", ERR_TAG),
            ("MPI_ERR_TYPE", ERR_TYPE), ("MPI_ERR_COUNT", ERR_COUNT),
            ("MPI_ERR_TRUNCATE", ERR_TRUNCATE),
            ("MPI_ERR_AMODE", ERR_AMODE), ("MPI_ERR_OP", ERR_OP),
            ("MPI_ERR_BUFFER", ERR_BUFFER),
            ("MPI_ERR_KEYVAL", ERR_KEYVAL),
            ("MPI_ERR_INFO", ERR_INFO)):
        if marker in text:
            return code
    if isinstance(exc, FileNotFoundError):
        return ERR_NO_SUCH_FILE
    if isinstance(exc, PermissionError):
        return ERR_ACCESS
    if isinstance(exc, (OSError, IOError)):
        return ERR_IO
    if isinstance(exc, (ValueError, TypeError)):
        return ERR_ARG
    return ERR_OTHER


class Errhandler:
    """Per-object error handler (comm/win/file attachable)."""

    def __init__(self, fn: Optional[Callable] = None,
                 name: str = "user") -> None:
        self.fn = fn
        self.name = name

    def __repr__(self) -> str:
        return f"<Errhandler {self.name}>"


ERRORS_ARE_FATAL = Errhandler(None, "MPI_ERRORS_ARE_FATAL")
ERRORS_RETURN = Errhandler(None, "MPI_ERRORS_RETURN")
ERRORS_ABORT = Errhandler(None, "MPI_ERRORS_ABORT")  # MPI-4 alias


def attach_api(cls) -> None:
    """Install Set/Get/Call_errhandler methods on an MPI object class
    (comm, win, file — the three errhandler-bearing handle types)."""

    def Set_errhandler(self, handler) -> None:
        self.errhandler = handler

    def Get_errhandler(self):
        return self.errhandler

    def Call_errhandler(self, errorcode: int) -> None:
        dispatch(self, MPIException(errorcode))

    cls.Set_errhandler = Set_errhandler
    cls.Get_errhandler = Get_errhandler
    cls.Call_errhandler = Call_errhandler


def dispatch(obj, exc: BaseException, state=None):
    """Route an error through `obj`'s installed handler
    (ref: OMPI_ERRHANDLER_INVOKE): FATAL/ABORT aborts the job via the
    rte; RETURN re-raises (the Python 'return code'); a user handler
    runs fn(obj, code) first, then the exception propagates.

    A handler-less object resolves through the world communicator's
    installed handler when a state is reachable, else ERRORS_RETURN
    (the port has no MCA choice of the job default yet)."""
    handler = getattr(obj, "errhandler", None)
    if handler is None:
        st = state or getattr(obj, "state", None)
        cw = getattr(st, "comm_world", None) if st is not None else None
        handler = getattr(cw, "errhandler", None) or ERRORS_RETURN
    code = classify(exc)
    if handler in (ERRORS_ARE_FATAL, ERRORS_ABORT):
        st = state or getattr(obj, "state", None)
        if st is not None:
            st.rte.abort(code or 1,
                         f"{error_string(code)}: {exc}")
        raise SystemExit(code or 1)
    if handler.fn is not None:
        handler.fn(obj, code)
    raise exc
