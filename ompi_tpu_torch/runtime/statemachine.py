"""Event-driven job/proc state machine — the orte/mca/state analog.

Re-design of the reference's state machinery: ``ORTE_ACTIVATE_JOB_STATE``
posts an event that runs the handler registered for (role, state)
(ref: orte/mca/state/state.h:92-109; per-role state tables in
state_base_fns.c:428-843; hnp/orted/app components under
orte/mca/state/).  Differences from the reference:

  * the event loop is an explicit queue drained by ``run()`` on the
    launcher's main thread instead of libevent callbacks — activations
    may come from any thread (OOB dispatch, process reapers, timers,
    KV-server callbacks) and are serialized here;
  * errmgr policy IS a set of state handlers: failure events
    (PROC_FAILED / DAEMON_FAILED / ABORTED / TIMEOUT) are ordinary
    states whose handlers decide the transition to DRAINING (the
    errmgr/default_hnp "first abnormal exit kills the job" policy,
    ref: orte/mca/errmgr/default_hnp/errmgr_default_hnp.c);
  * a ``--verbose state`` trace prints every transition.

Launch lifecycle:

    INIT -> ALLOCATE -> MAP -> LAUNCH_DAEMONS -> DAEMONS_REPORTED
         -> LAUNCH_APPS -> RUNNING -> DRAINING -> TERMINATED

with error states entering from anywhere:

    PROC_FAILED, DAEMON_FAILED, ABORTED, TIMEOUT, LAUNCH_FAILED

The single-host direct path skips the daemon states
(INIT -> ALLOCATE -> MAP -> LAUNCH_APPS -> ...).
"""

from __future__ import annotations

import queue
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

# lifecycle states
INIT = "INIT"
ALLOCATE = "ALLOCATE"
MAP = "MAP"
LAUNCH_DAEMONS = "LAUNCH_DAEMONS"
DAEMONS_REPORTED = "DAEMONS_REPORTED"
LAUNCH_APPS = "LAUNCH_APPS"
RUNNING = "RUNNING"
DRAINING = "DRAINING"
TERMINATED = "TERMINATED"

# error states (handlers implement the errmgr policy)
PROC_FAILED = "PROC_FAILED"
DAEMON_FAILED = "DAEMON_FAILED"
ABORTED = "ABORTED"
TIMEOUT = "TIMEOUT"
LAUNCH_FAILED = "LAUNCH_FAILED"

# non-state events routed through the same queue so handlers stay
# serialized with transitions (spawn requests, proc exits, node
# completions, daemon registrations)
EVENT_PREFIX = "EV_"


class StateMachine:
    """One job's state machine; owned by the launcher (HNP role) or a
    daemon (orted role)."""

    def __init__(self, role: str = "hnp", verbose: bool = False,
                 name: str = "mpirun") -> None:
        self.role = role
        self.verbose = verbose
        self.name = name
        self.state = INIT
        self.exit_code = 0
        self.data: Dict[str, Any] = {}  # handler blackboard
        self._handlers: Dict[str, Callable] = {}
        self._events: "queue.Queue[Tuple[str, dict]]" = queue.Queue()
        self._seen_terminal = False
        self._timer: Optional[threading.Timer] = None

    # -- registration --------------------------------------------------
    def register(self, state: str,
                 handler: Callable[["StateMachine", dict], None]) -> None:
        """Install the handler for ``state`` (replacing any previous
        one — the reference's state-table override semantics)."""
        self._handlers[state] = handler

    def register_table(self, table: Dict[str, Callable]) -> None:
        for state, handler in table.items():
            self.register(state, handler)

    # -- activation (any thread) ---------------------------------------
    def activate(self, state: str, **info: Any) -> None:
        """Post ``state`` to the event queue (the
        ORTE_ACTIVATE_JOB_STATE analog).  Never blocks; never runs the
        handler inline."""
        self._events.put((state, info))

    def start_timeout(self, seconds: float) -> None:
        """Arm the job timeout (activates TIMEOUT)."""
        if seconds and seconds > 0:
            self._timer = threading.Timer(
                seconds, lambda: self.activate(TIMEOUT, seconds=seconds))
            self._timer.daemon = True
            self._timer.start()

    # -- event loop ----------------------------------------------------
    def _trace(self, prev: str, state: str, info: dict) -> None:
        if self.verbose:
            extra = " ".join(f"{k}={v!r}" for k, v in info.items()
                             if k not in ("proc",))
            sys.stderr.write(
                f"[{self.name}:{self.role}:state] {prev} -> {state}"
                + (f" ({extra})" if extra else "") + "\n")
            sys.stderr.flush()

    def dispatch(self, state: str, info: dict) -> None:
        handler = self._handlers.get(state)
        prev = self.state
        if not state.startswith(EVENT_PREFIX):
            self.state = state
            self._trace(prev, state, info)
        if handler is not None:
            handler(self, info)

    def run(self) -> int:
        """Drain events until TERMINATED; returns the job exit code."""
        while self.state != TERMINATED:
            try:
                state, info = self._events.get(timeout=60.0)
            except queue.Empty:
                continue  # quiescent running job: keep waiting
            self.dispatch(state, info)
        if self._timer is not None:
            self._timer.cancel()
        return self.exit_code
