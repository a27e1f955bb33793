"""Measured collective selection: one-shot calibration of the real
dispatch constant and host-path latency.

The static thresholds in coll/tuned (10 KB recursive-doubling cutoff,
256 KiB pipeline cutoff, ...) and the device tiers' static crossovers
(coll_pipeline_min_bytes, coll_seg_size) encode assumptions about the
per-op device dispatch constant that a given host may falsify.

This module is the re-design of the reference's *dynamic* decision
mechanism (ref: coll_tuned_dynamic_file.c:46-64 — rule files beat the
compiled-in fixed decision when ``coll_tuned_use_dynamic_rules`` is
set): instead of a hand-written rule file, a one-shot calibration
probe measures

  * ``dispatch_us``   — the per-op device dispatch constant (a tiny
    chained torch op on the card, timed to completion),
  * ``host_alpha_us`` — the host path's per-message constant (a
    cross-thread condvar round trip: the rendezvous/btl-inproc
    latency unit), and
  * ``host_gbs``      — host memcpy bandwidth,

and derives per-collective device-vs-host crossover sizes plus
measured alpha-beta thresholds for the intra-host algorithm picks.
The profile is cached per host+backend (JSON in the temp directory),
so later jobs — and comm creation inside a job — load it instead of
re-measuring.  The backend is torch's (``cuda`` or ``cpu``) and the
file name carries the package, so this port and the reference never
share a profile file.

Selection is opt-in the Open MPI way:

    mpirun --mca coll_tuned_use_measured_rules 1 ...

With the flag off (default) every decision falls back to the static
thresholds, so the measured plane can never surprise a tuned
deployment.
"""

from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, Optional

import numpy as np

from ompi_tpu_torch.mca.params import registry

use_measured_var = registry.register(
    "coll", "tuned", "use_measured_rules", False, bool,
    help="Replace the static size thresholds in coll/tuned and the "
         "device tiers' crossovers with values derived "
         "from a measured per-host profile (dispatch constant, host "
         "alpha/beta).  The profile is loaded from "
         "coll_tuned_profile_path or measured once per process "
         "(ref: coll_tuned_use_dynamic_rules)")
profile_path_var = registry.register(
    "coll", "tuned", "profile_path", "", str,
    help="Path of the cached per-host calibration profile (JSON).  "
         "Empty = <tempdir>/tpumpi-torch-profile-<host>-<backend>"
         ".json")

# kinds the crossover plane knows; factors scale the host beta term
# by each collective's bytes-moved-per-rank relative to its payload
# (allreduce moves ~2n through the root/ring, bcast and alltoall ~n)
_KIND_TRAFFIC = {"allreduce": 2.0, "bcast": 1.0, "alltoall": 1.0}
_CROSSOVER_CAP = 4 << 20  # never route >4 MiB to the host path

_lock = threading.Lock()
_profile: Optional[Dict] = None
_profile_key: Optional[str] = None  # path it was loaded from/saved to


def use_measured_rules() -> bool:
    return bool(use_measured_var.value)


def _backend_name() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def default_profile_path() -> str:
    import socket
    import tempfile
    host = socket.gethostname().split(".")[0] or "local"
    return os.path.join(
        tempfile.gettempdir(),
        f"tpumpi-torch-profile-{host}-{_backend_name()}.json")


def _path() -> str:
    return profile_path_var.value or default_profile_path()


# ---------------------------------------------------------------------------
# probes
# ---------------------------------------------------------------------------

def probe_dispatch_us(reps: int = 32) -> float:
    """Per-op device dispatch constant: chained tiny torch ops on the
    card (each input depends on the previous output), timed from the
    first launch to the synchronize after the last.  Raises when no
    card is present."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card to probe")
    x = torch.zeros(8, device="cuda")
    x = x + 1.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        x = x + 1.0
    torch.cuda.synchronize()
    return max(0.1, (time.perf_counter() - t0) / reps * 1e6)


def probe_host_alpha_us(rounds: int = 200) -> float:
    """Host per-message constant: a cross-thread condvar round trip —
    the latency unit of both the inproc btl and the rendezvous meet."""
    cv = threading.Condition()
    state = {"turn": 0, "stop": False}

    def echo() -> None:
        with cv:
            while not state["stop"]:
                while state["turn"] != 1 and not state["stop"]:
                    cv.wait(0.1)
                if state["stop"]:
                    return
                state["turn"] = 0
                cv.notify_all()

    t = threading.Thread(target=echo, daemon=True)
    t.start()
    # warm the thread up before timing
    for _ in range(10):
        with cv:
            state["turn"] = 1
            cv.notify_all()
            while state["turn"] != 0:
                cv.wait(0.1)
    t0 = time.perf_counter()
    for _ in range(rounds):
        with cv:
            state["turn"] = 1
            cv.notify_all()
            while state["turn"] != 0:
                cv.wait(0.1)
    elapsed = time.perf_counter() - t0
    with cv:
        state["stop"] = True
        cv.notify_all()
    t.join(1.0)
    return max(0.1, elapsed / rounds * 1e6)


def probe_host_gbs(nbytes: int = 1 << 20, reps: int = 20) -> float:
    """Host memcpy bandwidth (beta term of the host path)."""
    src = np.ones(nbytes, np.uint8)
    dst = np.empty_like(src)
    np.copyto(dst, src)  # warm
    t0 = time.perf_counter()
    for _ in range(reps):
        np.copyto(dst, src)
    elapsed = time.perf_counter() - t0
    return max(0.01, nbytes * reps / elapsed / 1e9)


def measure_profile() -> Dict:
    """The one-shot analytic calibration (comm-creation fallback when
    no swept profile is cached).  ~10 ms of wall clock."""
    prof: Dict = {
        "host": os.uname().nodename if hasattr(os, "uname") else "local",
        "backend": _backend_name(),
        "source": "analytic_probe",
        "host_alpha_us": probe_host_alpha_us(),
        "host_gbs": probe_host_gbs(),
    }
    try:
        prof["dispatch_us"] = probe_dispatch_us()
    except Exception as e:  # noqa: BLE001 — no device: host rules only
        prof["dispatch_us"] = None
        prof["dispatch_error"] = str(e)[:120]
    prof["crossover_bytes"] = {
        kind: _solve_crossover(prof, kind) for kind in _KIND_TRAFFIC}
    prof["seg_bytes"] = _solve_segment_bytes(prof)
    prof["seg_crossover_bytes"] = {
        kind: max(2 * prof["seg_bytes"], 1 << 20)
        for kind in _KIND_TRAFFIC}
    prof["hier_min_bytes"] = prof["seg_bytes"]
    return prof


def _solve_segment_bytes(prof: Dict) -> int:
    """Per-host segment size for the pipelined large-message tier:
    the smallest segment whose transfer time keeps the per-segment
    dispatch constant under ~10% overhead (larger segments waste
    overlap; smaller ones re-pay the dispatch constant per chunk)."""
    disp = prof.get("dispatch_us")
    if disp is None:
        return 1 << 20
    n = 10.0 * disp * prof["host_gbs"] * 1e3  # us * bytes/us
    return int(min(max(n, 256 << 10), _CROSSOVER_CAP))


def _solve_crossover(prof: Dict, kind: str) -> int:
    """Smallest payload where the device path (flat dispatch constant)
    beats the host path (alpha * hops + traffic/beta).  Below it the
    host path wins and the device module reroutes."""
    disp = prof.get("dispatch_us")
    if disp is None:
        return 0  # no device: never reroute (device path ineligible)
    alpha = prof["host_alpha_us"]
    beta_us_per_b = 1.0 / (prof["host_gbs"] * 1e3)  # us per byte
    # host hop counts at the calibration size (8 thread-ranks is the
    # canonical host shape; log2 terms move slowly in P)
    hops = {"allreduce": 2 * 3.0, "bcast": 3.0, "alltoall": 7.0}[kind]
    base = alpha * hops
    if base >= disp:
        return 0  # host constant already above dispatch: device wins
    n = (disp - base) / (_KIND_TRAFFIC[kind] * beta_us_per_b * hops)
    return int(min(max(0.0, n), _CROSSOVER_CAP))


# ---------------------------------------------------------------------------
# persistence + cached access
# ---------------------------------------------------------------------------

def save_profile(prof: Dict, path: Optional[str] = None) -> str:
    global _profile, _profile_key
    path = path or _path()
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as fh:
        json.dump(prof, fh, indent=1)
    os.replace(tmp, path)
    with _lock:
        _profile, _profile_key = dict(prof), path
    return path


def load_profile(path: Optional[str] = None) -> Optional[Dict]:
    path = path or _path()
    try:
        with open(path) as fh:
            prof = json.load(fh)
    except (OSError, ValueError):
        return None
    return prof if isinstance(prof, dict) else None


def get_profile(create: bool = True) -> Optional[Dict]:
    """The process-wide profile: cached -> file -> fresh measurement.
    Process-wide (not per comm) so every rank-thread of a host reaches
    the SAME selection verdicts — a per-rank probe could diverge and
    split a comm across algorithms (deadlock)."""
    global _profile, _profile_key
    path = _path()
    with _lock:
        if _profile is not None and _profile_key == path:
            return _profile
    prof = load_profile(path)
    if prof is None and create:
        prof = measure_profile()
        try:
            save_profile(prof, path)
        except OSError:
            pass  # unwritable tempdir: keep the in-memory profile
    with _lock:
        _profile, _profile_key = prof, path
    return prof


def reset_cache() -> None:
    """Testing hook: forget the cached profile (e.g. after pointing
    coll_tuned_profile_path somewhere else)."""
    global _profile, _profile_key
    with _lock:
        _profile, _profile_key = None, None


def update_profile(fields: Dict, persist: bool = False) -> Dict:
    """Merge ``fields`` into the process-wide profile IN MEMORY (the
    online-autotune write path: coll/autotune folds EWMA-updated
    thresholds here between probe runs).  The merged profile replaces
    the cached one immediately — every rank-thread of the process sees
    the same updated decision surface, preserving the comm-consistency
    property get_profile() documents.  With ``persist`` the merge is
    also written to the profile file (best effort; an unwritable path
    keeps the in-memory update)."""
    global _profile, _profile_key
    prof = dict(get_profile(create=True) or {})
    prof.update(fields)
    path = _path()
    with _lock:
        _profile, _profile_key = prof, path
    if persist:
        try:
            save_profile(prof, path)
        except OSError:
            pass
    return prof


# ---------------------------------------------------------------------------
# the decision surface consumed by coll/tuned and coll/device
# ---------------------------------------------------------------------------

def crossover_bytes(kind: str, comm_size: int) -> int:
    """Device-vs-host crossover for ``kind``; 0 when unknown (then the
    device path is never rerouted)."""
    prof = get_profile()
    if not prof:
        return 0
    cx = (prof.get("crossover_bytes") or {}).get(kind)
    return int(cx) if cx else 0


def segment_bytes(comm_size: int, static: int) -> int:
    """Segment size for the pipelined large-message tier
    (docs/DESIGN.md §12): the calibrated per-host value under measured
    rules, else the ``coll_seg_size`` static."""
    if not use_measured_rules():
        return static
    prof = get_profile()
    sb = (prof or {}).get("seg_bytes")
    return int(sb) if sb else static


def segmented_crossover(kind: str, comm_size: int, static: int) -> int:
    """Payload size where the segmented pipeline overtakes the fused
    single-dispatch device path for ``kind``; ``static`` (the
    ``coll_pipeline_min_bytes`` knob) when measured rules are off or
    the profile has no swept value."""
    if not use_measured_rules():
        return static
    prof = get_profile()
    cx = ((prof or {}).get("seg_crossover_bytes") or {}).get(kind)
    return int(cx) if cx else static


def hier_min_bytes(comm_size: int, static: int) -> int:
    """Minimum payload for the hierarchical tier (the leader hop's
    host-path latency must amortize)."""
    if not use_measured_rules():
        return static
    prof = get_profile()
    hm = (prof or {}).get("hier_min_bytes")
    return int(hm) if hm else static


def _ladder():
    n = 1024
    while n <= (16 << 20):
        yield n
        n <<= 1


def measured_threshold(name: str, comm_size: int, static: int) -> int:
    """Measured replacement for a static tuned threshold; returns
    ``static`` when measured rules are off or no profile exists.

    Alpha-beta models (alpha = measured cross-thread constant, beta =
    measured memcpy bandwidth), scanned over a size ladder:

      * ``allreduce_small``  — recursive-doubling vs ring crossover
      * ``bcast_pipeline``   — binomial vs segmented-pipeline
      * ``alltoall_bruck``   — bruck vs pairwise
    """
    if not use_measured_rules():
        return static
    prof = get_profile()
    if not prof:
        return static
    alpha = prof["host_alpha_us"]
    beta = 1.0 / (prof["host_gbs"] * 1e3)  # us/byte
    p = max(2, comm_size)
    logp = math.log2(p)
    if name == "allreduce_small":
        # T_rd = logP(a + 2nB); T_ring = 2(P-1)a + 2n(P-1)/P * B
        for n in _ladder():
            t_rd = logp * (alpha + 2 * n * beta)
            t_ring = 2 * (p - 1) * alpha + 2 * n * (p - 1) / p * beta
            if t_ring < t_rd:
                return n
        return _CROSSOVER_CAP
    if name == "bcast_pipeline":
        seg = 64 * 1024
        for n in _ladder():
            t_bin = logp * (alpha + n * beta)
            nseg = max(1, n // seg)
            t_pipe = (p - 2 + nseg) * (alpha + min(n, seg) * beta)
            if t_pipe < t_bin:
                return n
        return _CROSSOVER_CAP
    if name == "alltoall_bruck":
        # bruck wins below the size where pairwise's lower traffic
        # beats bruck's fewer rounds
        for n in _ladder():
            t_bruck = logp * (alpha + (n * p / 2) * beta)
            t_pair = (p - 1) * (alpha + n * beta)
            if t_pair < t_bruck:
                return n
        return _CROSSOVER_CAP
    return static
