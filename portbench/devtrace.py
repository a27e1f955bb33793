"""The reduction of a ``torch.profiler`` trace of the window.

Device activity (kernels, copies, sets: every event on a CUDA device,
whatever its name) is put on the harness's host clock, clipped to the
window, and reduced to each card's busy time (the union of its
intervals), the idle gaps between them, and the time by operation
name.  A gap is named by what the host was doing at its middle: which
of the harness's spans (``traffic.Caller.NAMES``) was open on which
rank.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

# (card, name, start ns, end ns) on the harness's clock (perf_counter_ns)
Event = Tuple[int, str, int, int]


def clock_offset() -> int:
    """What to add to a profiler timestamp (the wall clock, ns since the
    epoch) to put it on the harness's clock (perf_counter_ns)."""
    p0 = time.perf_counter_ns()
    r = time.time_ns()
    p1 = time.perf_counter_ns()
    return (p0 + p1) // 2 - r


def profiler_events(prof) -> List[Tuple[int, str, int, int]]:
    """(device index, name, start ns, end ns) of every device event in
    the profiler's clock."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        s = int(e.start_ns())
        out.append((int(e.device_index()), e.name(), s,
                    s + int(e.duration_ns())))
    return out


def align(raw: Sequence[Tuple[int, str, int, int]], offset: int,
          window: Tuple[int, int]) -> List[Event]:
    """Put the events on the harness's clock.  Raises ValueError when
    the median event falls outside the window (1 s either side): the
    profiler then kept another clock than the wall clock."""
    if not raw:
        return []
    mid = sorted(s for _, _, s, _ in raw)[len(raw) // 2] + offset
    w0, w1 = window
    if not w0 - 10**9 <= mid <= w1 + 10**9:
        raise ValueError(f"the profiler's events lie "
                         f"{(mid - w0) * 1e-9:.3f} s from the window's "
                         f"start on the wall clock")
    return [(c, n, s + offset, e + offset) for c, n, s, e in raw]


def union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


@dataclass
class DevTrace:
    window_ns: Tuple[int, int]
    cards: List[int]
    busy_ns: Dict[int, int]                     # card -> busy ns
    by_name: List[Tuple[str, float]]            # (name, seconds), largest first
    gaps: List[Tuple[int, int, int]]            # (length ns, card, middle ns)
    n_events: int
    named_gaps: List[Tuple[str, float]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window_ns[1] - self.window_ns[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        """Busy seconds, the mean over the cards used."""
        return sum(self.busy_ns.get(c, 0) for c in self.cards) \
            / len(self.cards) * 1e-9


def reduce(events: Sequence[Event], window: Tuple[int, int],
           cards: Sequence[int]) -> DevTrace:
    w0, w1 = window
    per: Dict[int, List[Tuple[int, int]]] = {c: [] for c in cards}
    names: Dict[str, int] = {}
    for c, n, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        per.setdefault(c, []).append((s, e))
        names[n] = names.get(n, 0) + (e - s)
    busy, gaps = {}, []
    for c in cards:
        u = union(per.get(c, []))
        busy[c] = sum(e - s for s, e in u)
        t = w0
        for s, e in u + [(w1, w1)]:
            if s > t:
                gaps.append((s - t, c, (s + t) // 2))
            t = max(t, e)
    gaps.sort(reverse=True)
    by_name = sorted(((n, d * 1e-9) for n, d in names.items()),
                     key=lambda x: -x[1])
    return DevTrace(window, list(cards), busy, by_name, gaps, len(events))


def _ranges(ranks: List[int]) -> str:
    out, i = [], 0
    while i < len(ranks):
        j = i
        while j + 1 < len(ranks) and ranks[j + 1] == ranks[j] + 1:
            j += 1
        out.append(f"{ranks[i]}" if i == j else f"{ranks[i]}-{ranks[j]}")
        i = j + 1
    return ",".join(out)


class HostSpans:
    """Each rank's harness spans, for 'what was the host doing at t'."""

    def __init__(self, spans: Sequence[Sequence[Tuple[int, int, int]]],
                 names: Sequence[str]) -> None:
        self.names = names
        self.rows = []
        for sp in spans:
            sp = sorted(sp, key=lambda x: x[1])
            self.rows.append(([s[1] for s in sp], sp))

    def at(self, t: int) -> str:
        what: Dict[str, List[int]] = {}
        for r, (starts, sp) in enumerate(self.rows):
            i = bisect.bisect_right(starts, t) - 1
            name = "harness"
            if i >= 0 and sp[i][2] >= t:
                name = self.names[sp[i][0]]
            what.setdefault(name, []).append(r)
        return " ".join(f"{n}[r{_ranges(rs)}]" for n, rs in sorted(what.items()))


def name_gaps(dt: DevTrace, host: HostSpans, top: int = 10) -> None:
    dt.named_gaps = [(f"cuda:{c} idle, host {host.at(mid)}", g * 1e-9)
                     for g, c, mid in dt.gaps[:top]]
