"""The port's meeting spans, read from the ranks' trace dumps after a
traced run.

Loading this module (the readers of ``meet_lock_ms``, ``meet_wake_ms``
and ``body_gap_ms`` import it, and the harness loads every reader
before it runs the cell) points the port's ``trace_dump_path`` at
``DUMPS``, a template in the temporary directory that is this
process's own, where the port records the meeting (its ``meet`` span
category).  A traced run's ranks then write their rings there at
finalize; an untraced run has no tracer and writes nothing.  ``spans``
reads the dumps at a run's first read, removes them, and gives each
rank's spans of ``NAMES`` inside the window on the harness's clock
(``perf_counter_ns``).  Where there are no such dumps (a checkout
before the meeting's spans), or a ring lost events, it gives None and
every reader reports nothing.
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

# (start ns, end ns, (cid, seq), third arg): nbytes, or the card for
# meet_device
Span = Tuple[int, int, Tuple[int, int], int]

#: the meeting's spans and the phase ctx's wait, which the readers use
NAMES = ("meet_lock", "meet_wait", "meet_post", "meet_device",
         "ph_rdv_wait")
DUMPS = os.path.join(tempfile.gettempdir(),
                     f"portbench-{os.getpid()}-trace-r%r.json")


def paths(nranks: int) -> List[str]:
    return [DUMPS.replace("%r", str(r)) for r in range(nranks)]


def _remove(nranks: int = 256) -> None:
    for p in paths(nranks):
        if os.path.exists(p):
            os.remove(p)


def _arm() -> None:
    try:
        from ompi_tpu_torch import trace
        from ompi_tpu_torch.mca.params import registry
    except ImportError:
        return
    if "meet" in getattr(trace, "SPAN_CATS", ()):
        registry.set("trace_dump_path", DUMPS)
        atexit.register(_remove)


_arm()


def load(files: Sequence[str], window: Tuple[int, int],
         names: Sequence[str] = NAMES
         ) -> Optional[List[Dict[str, List[Span]]]]:
    """Rank -> name -> the spans of ``names`` inside ``window``, sorted
    by start, from each rank's dump in ``files``; None when a dump is
    missing or lost events (its ring overwrote some, or the meet
    category dropped a device pair)."""
    w0, w1 = window
    out = []
    for path in files:
        try:
            with open(path) as fh:
                doc = json.load(fh)
        except (OSError, ValueError):
            return None
        # a full ring may have overwritten events
        if len(doc["events"]) >= doc["capacity"] or \
                doc.get("dropped_by_cat", {}).get("meet"):
            return None
        wall, perf = doc["anchor"]["wall_s"], doc["anchor"]["perf_ns"]
        per: Dict[str, List[Span]] = {n: [] for n in names}
        for e in doc["events"]:
            rows = per.get(e["name"])
            if rows is None or e.get("ph") != "X":
                continue
            s = perf + int(round((e["ts"] - wall) * 1e9))
            t = s + int(round(e["dur"] * 1e9))
            if s >= w0 and t <= w1:
                a = e.get("args") or {}
                rows.append((s, t, (a.get("cid"), a.get("seq")),
                             a.get("card", a.get("nbytes"))))
        for rows in per.values():
            rows.sort()
        out.append(per)
    return out


@functools.lru_cache(maxsize=1)
def _read(nranks: int, window: Tuple[int, int]):
    files = paths(nranks)
    try:
        return load(files, window)
    finally:
        for p in files:
            if os.path.exists(p):
                os.remove(p)


def spans(run) -> Optional[List[Dict[str, List[Span]]]]:
    """The window's meeting spans of ``run``'s ranks, or None."""
    got = _read(run.nranks, tuple(run.window_ns))
    if got is None or not any(per["meet_lock"] for per in got):
        return None
    return got
