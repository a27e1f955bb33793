"""Process statistics — the opal/mca/pstat analog.

Re-design of opal/mca/pstat/linux (ref:
opal/mca/pstat/linux/pstat_linux_module.c — /proc scraping into
opal_pstats_t: state, cpu times, vsize/rss, threads).  Exposed as a
plain snapshot function plus MPI_T-style pvar registration so
``ompi_info``/tooling can sample a rank's footprint.
"""

from __future__ import annotations

import os
from typing import Dict, Optional


def snapshot(pid: Optional[int] = None) -> Dict[str, float]:
    """One process-stat sample (the pstat_query analog).  Returns
    empty dict off-Linux rather than failing — diagnostics must never
    take a rank down."""
    pid = pid or os.getpid()
    out: Dict[str, float] = {}
    try:
        with open(f"/proc/{pid}/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        # fields are 0-indexed from field 3 ("state") here
        tck = os.sysconf("SC_CLK_TCK") or 100
        out["state"] = float(ord(fields[0][0]))
        out["utime_s"] = int(fields[11]) / tck
        out["stime_s"] = int(fields[12]) / tck
        out["threads"] = float(fields[17])
        out["vsize_mb"] = int(fields[20]) / (1024 * 1024)
        page = os.sysconf("SC_PAGE_SIZE")
        out["rss_mb"] = int(fields[21]) * page / (1024 * 1024)
    except (OSError, IndexError, ValueError):
        return {}
    try:
        with open(f"/proc/{pid}/statm") as fh:
            statm = fh.read().split()
        page = os.sysconf("SC_PAGE_SIZE")
        out["shared_mb"] = int(statm[2]) * page / (1024 * 1024)
    except (OSError, IndexError, ValueError):
        pass
    return out


# ranks whose pvars are already registered: mpi_init runs once per
# WORLD but the registry is process-global, so looped tests creating
# world after world would otherwise re-register rss_mb_r{rank} and
# either collide or silently orphan the fresh getters
_registered: set = set()


def register_pvars(rank: int) -> None:
    """Publish live-sampled pvars (rss/threads) for this rank — the
    MPI_T face of the pstat framework (read-time getters).
    Idempotent per rank across repeated world creation."""
    from ompi_tpu_torch.mca.params import registry

    if rank in _registered:
        return
    _registered.add(rank)
    registry.register_pvar(
        "opal", "pstat", f"rss_mb_r{rank}", var_class="level",
        help="Resident set size (MiB), sampled at read",
        getter=lambda: snapshot().get("rss_mb", 0.0))
    registry.register_pvar(
        "opal", "pstat", f"threads_r{rank}", var_class="level",
        help="OS thread count, sampled at read",
        getter=lambda: snapshot().get("threads", 0.0))
