"""Request-scoped trace context: the trace id that names one request of
the resident pool end to end, its span ids, and their display and parse
forms.

Port of the reference's ``ompi_tpu/obs/reqtrace.py``.  ``mint()``
produces a (trace id, parent span) pair at ``DvmClient.attach``;
``next_span()`` names each run under it.  The ids ride the pool's RPC
as two plain ints, land on the server's session, are stamped into each
resident rank's tracer (``Tracer.req_mark``), published into the
session's KV namespace, and annotate the pool's admission, park,
resume and run flight events.  The hang doctor (``tools/doctor.py``)
prints a capture's trace id with ``fmt`` and filters captures by
``--job`` with ``parse``.

Ids are 63-bit positive integers (they must fit the flight recorder's
and the tracer's signed ``array('q')`` columns) built from wall
nanoseconds, the pid and a process-monotonic counter; 0 means "no
context".  Span ids are small per-process counters.  Everything is
gated on ``obs_reqtrace_enable`` (off by default): when off, ``mint()``
is never called and no RPC field is added.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Tuple

from ompi_tpu_torch.mca.params import registry

_enable_var = registry.register(
    "obs", "reqtrace", "enable", False, bool,
    help="Mint a request trace context (trace id + parent span) at "
         "DvmClient attach/run and propagate it end-to-end: RPC "
         "fields, admission/park/resume flight events, per-job rank "
         "tracer tags, KV namespace.  Off = no context is minted and "
         "runs carry tag 0")

_MASK63 = (1 << 63) - 1

_span_n = itertools.count(1)


def enabled() -> bool:
    return bool(_enable_var.value)


def mint() -> Tuple[int, int]:
    """A fresh (trace id, parent span) pair.  The tid folds wall
    nanoseconds, the pid and a process counter into 63 bits; the span
    is this process's next span id."""
    n = next(_span_n)
    tid = ((time.time_ns() & 0xFFFFFFFFFF) << 23) \
        ^ ((os.getpid() & 0x7FFFFF) << 16) ^ (n & 0xFFFF)
    tid &= _MASK63
    if tid == 0:
        tid = 1  # 0 means "no context" everywhere downstream
    return tid, n


def next_span() -> int:
    """The next span id under an existing trace (one per run RPC)."""
    return next(_span_n)


def fmt(tid: int) -> str:
    """Canonical display form of a trace id (hex, the --job syntax)."""
    return f"0x{tid:x}"


def parse(text: str) -> int:
    """Parse a --job argument: hex with 0x prefix, or decimal."""
    s = str(text).strip()
    return int(s, 16) if s.lower().startswith("0x") else int(s)
