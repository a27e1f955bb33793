"""The arithmetic of the metrics: bus bytes, percentiles, the table of
peaks and the least time a collective needs on the card.

Bus bytes follow nccl-tests' PERFORMANCE.md: an allreduce moves
2(P-1)/P * S, a reduce_scatter, an allgather and an alltoall (P-1)/P
* S and a bcast S, with S one rank's (packed) send buffer in bytes,
except for allgather, where S is the gathered buffer (P times the send).

The least time is counted from the collective's own work, whatever
implements it:
* all ranks on one card: every input element the op needs read once and
  every output element written once, at the card's HBM rate;
* one rank a card: the larger of the card's own input read once and
  output written once at the HBM rate, and the bytes the card must take
  in over NVLink at NVLink's rate each way (allreduce 2(P-1)/P * S,
  reduce_scatter and alltoall (P-1)/P * S, allgather (P-1) * S, bcast S).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

# Published peaks (NVIDIA H100 SXM5 data sheet): HBM3 3.35 TB/s; NVLink 4,
# 18 links of 25 GB/s each way = 450 GB/s each way.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_Bps": 3.35e12, "nvlink_Bps": 450e9},
}


def bus_factor(kind: str, nranks: int) -> float:
    p = nranks
    return {"allreduce": 2 * (p - 1) / p, "reduce_scatter": (p - 1) / p,
            "allgather": (p - 1) / p, "alltoall": (p - 1) / p,
            "bcast": 1.0}[kind]


def bus_bytes(kind: str, nranks: int, send_bytes: int) -> float:
    """Bus bytes of one op."""
    s = send_bytes * (nranks if kind == "allgather" else 1)
    return bus_factor(kind, nranks) * s


def busbw_GBps(ops: int, bus_bytes_per_op: float, window_ns) -> float:
    """Bus bytes of ``ops`` ops over the window, in GB/s (1e9 B/s)."""
    w0, w1 = window_ns
    return ops * bus_bytes_per_op / ((w1 - w0) * 1e-9) / 1e9


def out_bytes(kind: str, nranks: int, send_bytes: int) -> int:
    """One rank's output bytes."""
    if kind == "reduce_scatter":
        return send_bytes // nranks
    if kind == "allgather":
        return send_bytes * nranks
    return send_bytes


def least_time_s(kind: str, nranks: int, cards: int, send_bytes: int,
                 peaks: dict) -> float:
    """The least device time of one op on each card, in seconds."""
    s, p = send_bytes, nranks
    o = out_bytes(kind, p, s)
    if cards == 1:
        read = s if kind == "bcast" else p * s
        return (read + p * o) / peaks["hbm_Bps"]
    if cards != p:
        raise ValueError("least_time_s: one card, or one rank a card")
    nvl_in = {"allreduce": 2 * (p - 1) / p * s,
              "reduce_scatter": (p - 1) / p * s,
              "alltoall": (p - 1) / p * s, "allgather": (p - 1) * s,
              "bcast": s}[kind]
    return max((s + o) / peaks["hbm_Bps"], nvl_in / peaks["nvlink_Bps"])


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by nearest rank: the smallest value with at
    least q % of the values at or under it."""
    if not values:
        raise ValueError("percentile of nothing")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles as a share of
    the median (Python's ``statistics.quantiles``, n=4)."""
    import statistics
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2


def peaks_for(device_name: Optional[str]) -> Optional[dict]:
    return PEAKS.get(device_name or "")
