"""PERUSE-analog: request-lifecycle event introspection.

Re-design of the reference's PERUSE layer (ref: ompi/peruse/peruse.h
— event handles like PERUSE_COMM_REQ_ACTIVATE /
PERUSE_COMM_REQ_MATCH_UNEX / PERUSE_COMM_REQ_COMPLETE registered per
communicator, fired from the pml).  Differences: events are plain
strings, subscriptions are process-wide callables, and the pml pays
a single module-flag check when nobody subscribed (the hot path must
not regress — same discipline as the reference compiling PERUSE out
by default).

Events fired by pml/ob1:

    req_activate   — a send/recv request entered the pml
                     (kind='send'|'recv', cid, peer, tag, bytes)
    req_match      — an incoming message matched a posted receive
    req_match_unex — an incoming message was queued unexpected
    req_complete   — a request completed (kind, bytes)

Events fired by the shared collective hooks (ompi_tpu_torch/trace — the
span tracer and PERUSE observe the SAME instrumentation points):

    coll_begin     — a blocking collective entered its merged-vtable
                     shim (cid, coll, seq)
    coll_end       — that collective returned (cid, coll, seq)
    nbc_activate   — a nonblocking-collective schedule was activated
                     (cid, coll, seq)
    nbc_complete   — that schedule finished its last round
                     (cid, coll, seq)

Usage:

    from ompi_tpu_torch import peruse
    peruse.subscribe("req_complete", lambda ev, **kw: stats.add(kw))
    ...
    peruse.unsubscribe_all()
"""

from __future__ import annotations

from typing import Callable, Dict, List

EVENTS = ("req_activate", "req_match", "req_match_unex",
          "req_complete",
          # collective / nonblocking-collective lifecycle (fired by
          # the shared hooks in ompi_tpu_torch/trace)
          "coll_begin", "coll_end", "nbc_activate", "nbc_complete")

# the pml checks this single flag before building event payloads
enabled = False

_subs: Dict[str, List[Callable]] = {e: [] for e in EVENTS}


def subscribe(event: str, cb: Callable) -> None:
    """Register ``cb(event, **info)`` for ``event`` (must be in
    EVENTS — the PERUSE_Event_comm_register analog)."""
    global enabled
    if event not in _subs:
        raise ValueError(f"unknown peruse event {event!r}; "
                         f"one of {EVENTS}")
    _subs[event].append(cb)
    enabled = True


def unsubscribe(event: str, cb: Callable) -> None:
    global enabled
    try:
        _subs[event].remove(cb)
    except (KeyError, ValueError):
        pass
    enabled = any(v for v in _subs.values())


def unsubscribe_all() -> None:
    global enabled
    for v in _subs.values():
        v.clear()
    enabled = False


def fire(event: str, **info) -> None:
    """Invoked by the pml only when ``enabled`` (subscriber errors
    propagate: an observability hook that raises is a test bug worth
    failing loudly, never a silently-dropped event)."""
    for cb in _subs.get(event, ()):
        cb(event, **info)
