"""OOB/RML analog: tag-dispatched control messaging between the
launcher (HNP) and per-node daemons.

Port of the reference's runtime/oob.py, a re-design of orte/mca/oob/tcp + orte/mca/rml (tag-based async
send_nb/recv_nb, ref: orte/mca/rml/rml.h:204,263): one TCP socket per
daemon⇄HNP pair, frames of 4-byte big-endian length + JSON, a reader
thread per channel dispatching on the message's "op" field.  The
control plane never carries data-plane traffic (that is the btl's
job), so JSON framing is fine; byte payloads (IOF lines) travel
latin-1-escaped.

Unlike the reference there is no routing overlay in the message path:
daemons connect directly to the HNP (the routed/direct component
model), while the *launch* may still fan out as a tree (plm tree
spawn, see tools/plm.py).
"""

from __future__ import annotations

import socket
import threading
from typing import Callable, Optional

from ompi_tpu_torch.mca.params import registry
from .kvstore import _recv_msg, _send_msg

# control-plane hardening knobs (shared by tools/tpud and tools/plm;
# registered here because both sides import oob)
retry_max_var = registry.register(
    "oob", "base", "retry_max", 5, int,
    help="Daemon-side reconnect attempts after its HNP channel drops "
         "before it gives up and kills its local procs")
retry_delay_var = registry.register(
    "oob", "base", "retry_delay", 0.25, float,
    help="Base daemon reconnect backoff (exponential, jittered, "
         "capped 5 s)")
heartbeat_interval_var = registry.register(
    "oob", "base", "heartbeat_interval", 2.0, float,
    help="Seconds between daemon->HNP liveness beats (0 disables "
         "sending)")
heartbeat_budget_var = registry.register(
    "oob", "base", "heartbeat_budget", 0, int,
    help="HNP declares a daemon lost after this many missed beat "
         "intervals — liveness by silence, not only by TCP death "
         "(0 disables monitoring)")
reconnect_grace_var = registry.register(
    "oob", "base", "reconnect_grace", 0.0, float,
    help="HNP holds EV_DAEMON_LOST this long after a channel drop, "
         "waiting for the daemon to reconnect (0 = fire immediately, "
         "the legacy behavior)")
host_grace_var = registry.register(
    "oob", "host", "grace_s", 0.0, float,
    help="Extra seconds of heartbeat silence tolerated before a WHOLE "
         "host is declared a lost failure domain (added on top of the "
         "per-daemon silence budget; 0 = no extra slack).  Consumed "
         "by the HNP beat monitor and the DVM host-liveness plane — "
         "one knob paces both host-granularity detectors")


def backoff_s(attempt: int, base: float, cap: float = 5.0) -> float:
    """One control-plane reconnect backoff step: exponential in
    ``attempt``, capped, with full 0.5x–1.5x jitter so a fleet of
    reconnecting clients never stampedes a freshly promoted standby
    or a supervisor-respawned server in lockstep.  The single
    definition every reconnect loop in the control plane sleeps on —
    daemon→HNP (tools/tpud) and KV client failover (runtime/kvstore)
    — so tuning recovery pacing changes ONE policy, not one copy per
    loop."""
    import random
    d = min(cap, max(0.001, base) * (2 ** min(6, max(0, attempt))))
    return d * (0.5 + random.random())


def silence_budget_s() -> float:
    """Heartbeat-silence horizon: how long a daemon may stay quiet
    before the HNP declares it lost (0.0 = monitoring disabled).
    The ULFM errmgr policy promotes this signal into per-rank failure
    records — the same budget, one definition."""
    if heartbeat_budget_var.value <= 0 or \
            heartbeat_interval_var.value <= 0:
        return 0.0
    return heartbeat_budget_var.value * heartbeat_interval_var.value


class Channel:
    """One framed bidirectional control connection.  ``send`` is
    thread-safe; inbound messages are dispatched from a dedicated
    reader thread to ``handler(msg)``; EOF/error fires
    ``on_close(exc_or_none)`` exactly once."""

    def __init__(self, sock: socket.socket,
                 handler: Callable[[dict], None],
                 on_close: Optional[Callable[[Optional[Exception]], None]]
                 = None) -> None:
        self.sock = sock
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.handler = handler
        self.on_close = on_close
        self._wlock = threading.Lock()
        self._closed = False
        self._reader = threading.Thread(target=self._read_loop, daemon=True)
        self._reader.start()

    def _read_loop(self) -> None:
        exc: Optional[Exception] = None
        try:
            while True:
                msg = _recv_msg(self.sock)
                if msg is None:
                    break
                self.handler(msg)
        except OSError as e:
            exc = e
        finally:
            closed_now = False
            with self._wlock:
                if not self._closed:
                    self._closed = True
                    closed_now = True
            if closed_now and self.on_close is not None:
                self.on_close(exc)

    def send(self, msg: dict) -> None:
        with self._wlock:
            if self._closed:
                raise ConnectionError("oob channel closed")
            _send_msg(self.sock, msg)

    def close(self) -> None:
        with self._wlock:
            self._closed = True
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


def connect(addr: str, handler: Callable[[dict], None],
            on_close: Optional[Callable[[Optional[Exception]], None]] = None,
            timeout: float = 60.0) -> Channel:
    host, port = addr.rsplit(":", 1)
    s = socket.create_connection((host, int(port)), timeout=timeout)
    s.settimeout(None)
    return Channel(s, handler, on_close)


def local_ip_toward(addr: str) -> str:
    """The IP this host would use to reach ``addr`` (the opal if/
    reachable analog collapsed to the UDP-connect trick: no packet is
    sent, the kernel just picks the route's source address)."""
    host, port = addr.rsplit(":", 1)
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        s.connect((host, int(port)))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()
