"""Request-scoped trace context: the display and parse forms of a trace
id, the key that names one request end to end.

Port of the display half of the reference's ``ompi_tpu/obs/reqtrace.py``
(``fmt`` and ``parse``).  Its user in the port is the hang doctor
(``tools/doctor.py``), which prints a capture's trace id with ``fmt``
and filters captures by ``--job`` with ``parse``.  The minting half
(``obs_reqtrace_enable``, ``enabled``, ``mint``, ``next_span``) is read
only by the DVM pool's attach and run, and comes with the pool
(ROADMAP.md A8).

Ids are 63-bit positive integers (they must fit the flight recorder's
and the tracer's signed ``array('q')`` columns); 0 means "no context".
"""

from __future__ import annotations


def fmt(tid: int) -> str:
    """Canonical display form of a trace id (hex, the --job syntax)."""
    return f"0x{tid:x}"


def parse(text: str) -> int:
    """Parse a --job argument: hex with 0x prefix, or decimal."""
    s = str(text).strip()
    return int(s, 16) if s.lower().startswith("0x") else int(s)
