"""Request lifecycle + completion (ref: ompi/request/request.h:381-432
— wait blocks on wait_sync, completion via atomic state transition;
test/wait{,all,any,some} in ompi/mpi/c/).
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

from ompi_tpu_torch.runtime.progress import Progress, WaitSync

ANY_SOURCE = -1
ANY_TAG = -1
PROC_NULL = -2

SUCCESS = 0
ERR_TRUNCATE = 15
ERR_PENDING = 19

# ULFM classes: a request drained with one of these must RAISE from
# wait (the op cannot have delivered data; silently returning a
# status would let the app consume garbage from a dead peer)
_ULFM_CODES = (75, 76, 77)  # PROC_FAILED, PROC_FAILED_PENDING, REVOKED


class Status:
    __slots__ = ("source", "tag", "error", "count", "cancelled")

    def __init__(self) -> None:
        self.source = ANY_SOURCE
        self.tag = ANY_TAG
        self.error = SUCCESS
        self.count = 0
        self.cancelled = False

    def get_count(self, datatype) -> int:
        if datatype.size == 0:
            return 0
        if self.count % datatype.size:
            return -1  # MPI_UNDEFINED
        return self.count // datatype.size

    def __repr__(self) -> str:
        return (f"Status(src={self.source}, tag={self.tag}, "
                f"err={self.error}, count={self.count})")


class Request:
    """Base request; owned (progressed) by the rank that created it."""

    def __init__(self, progress: Progress) -> None:
        self._progress = progress
        self._sync = WaitSync(1)
        self.status = Status()
        self.complete = False
        self.cancelled = False
        self.persistent = False
        self.active = True

    def _complete(self) -> None:
        self.complete = True
        self._sync.signal()

    def test(self) -> bool:
        if not self.complete:
            self._progress.progress()
        return self.complete

    def wait(self, timeout: Optional[float] = None) -> Status:
        if self._progress.interrupt is not None:
            # armed interrupts (ulfm rank_kill) must fire even when
            # the request completed inline: a rank that never runs
            # progress can never be killed
            self._progress.progress()
        if not self.complete:
            self._sync.wait(self._progress, timeout)
        if not self.complete:
            raise TimeoutError("request wait timed out")
        if self.status.error in _ULFM_CODES:
            from ompi_tpu_torch import errhandler as _eh
            raise _eh.MPIException(self.status.error)
        return self.status

    def cancel(self) -> None:
        """Best-effort MPI_Cancel (only unmatched receives succeed;
        matched/sent requests run to normal completion, per MPI)."""
        canceller = getattr(self, "_canceller", None)
        if canceller is not None and not self.complete:
            canceller(self)

    def free(self) -> None:
        pass


class CompletedRequest(Request):
    """Immediately-complete request (send-to-PROC_NULL etc.)."""

    def __init__(self, progress: Progress, count: int = 0) -> None:
        super().__init__(progress)
        self.status.count = count
        self._complete()


def wait_all(reqs: List[Request], timeout: Optional[float] = None
             ) -> List[Status]:
    deadline = None if timeout is None else time.monotonic() + timeout
    for r in reqs:
        t = None if deadline is None else max(0.0, deadline - time.monotonic())
        r.wait(t)
    return [r.status for r in reqs]


# pollers go through r.test(), not the raw `complete` flag: wrapper
# requests (e.g. PersistentRequest) sync their outer state there

def wait_any(reqs: List[Request]) -> int:
    if not reqs:
        return -1
    while True:
        for i, r in enumerate(reqs):
            if r.complete or r.test():
                return i


def wait_some(reqs: List[Request]) -> List[int]:
    if not reqs:
        return []
    while True:
        done = [i for i, r in enumerate(reqs) if r.complete or r.test()]
        if done:
            return done


def test_all(reqs: List[Request]) -> bool:
    return all(r.complete or r.test() for r in reqs)


def test_any(reqs: List[Request]):
    """MPI_Testany analog: (index, status) of one completed request,
    or (-1, None) when none is ready ((-1, None) also for [] like
    wait_any's empty guard)."""
    if not reqs:
        return -1, None
    for i, r in enumerate(reqs):
        if r.complete or r.test():
            return i, r.status
    return -1, None


def test_some(reqs: List[Request]) -> List[int]:
    """MPI_Testsome analog: indices completed right now (may be
    empty; never blocks)."""
    return [i for i, r in enumerate(reqs) if r.complete or r.test()]


def request_get_status(req: Request):
    """MPI_Request_get_status: (flag, status) without freeing."""
    done = req.complete or req.test()
    return done, (req.status if done else None)


class Grequest(Request):
    """Generalized request (ref: ompi/mpi/c/grequest_start.c): the
    user signals completion via .complete_now(); query_fn fills the
    status at completion-query time, free_fn/cancel_fn at the
    respective lifecycle points."""

    def __init__(self, progress: Progress, query_fn=None, free_fn=None,
                 cancel_fn=None, extra_state=None) -> None:
        super().__init__(progress)
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn
        self._extra = extra_state

    def complete_now(self) -> None:
        """MPI_Grequest_complete."""
        if self._query_fn is not None:
            self._query_fn(self._extra, self.status)
        self._complete()

    def cancel(self) -> None:
        if self._cancel_fn is not None:
            self._cancel_fn(self._extra, self.complete)
        super().cancel()

    def free(self) -> None:
        if self._free_fn is not None:
            self._free_fn(self._extra)
        super().free()
