"""Resident sessions in one process: the in-process half of the
reference's DVM pool (``ompi_tpu/tools/dvm.py``), with no socket plane.

A resident session is an independent thread world (``run_ranks``) in
its own cid band, so its communicators' ids, its pvar bands and its
meeting keys never meet another session's.  ``run_sessions`` runs k of
them at once and reports their count to the cross-session batcher
(``coll.fusion.set_xsession_hint``) for their life, as the pool does on
attach and detach, so that their fused batches may ride combined
dispatches (``dvm_batch_window_us``).  The pool's socket plane, when it
is ported, sits on top of this.

The hang doctor's half of the pool lives here too: ``doctor_capture``
builds the capture ``tools/doctor.py`` reduces from a live thread world
(the part of the reference pool's ``_doctor_capture`` that reads a
world), and ``poison`` unwinds a wedged world from outside it (the
thread-world part of the pool's ``_poison_session``).  The pool's
watchdog, when it is ported, calls both.

On the CPU: ``device_map=lambda r: torch.device("cpu")`` (coll/hbm) or
``device_map=logical_devices("cpu")`` (the mesh tier), with the
kernels' plain versions.  On the card: the default (``devices=True``:
rank r of every session on ``cuda:(r % cards)``), or
``logical_devices("cuda:0")`` for a mesh of logical devices.
"""

from __future__ import annotations

import sys
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional

from ompi_tpu_torch import obs
from ompi_tpu_torch.coll import fusion
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.testing import _card_map, run_ranks


def run_sessions(k: int, n: int, fn: Callable, devices: bool = True,
                 device_map=None, window_us: Optional[int] = None,
                 timeout: float = 120.0) -> List[List[Any]]:
    """Run fn(comm_world) on k sessions of n thread-ranks each, all at
    once, session s (0-based) in cid band s + 1; returns results[s][r].

    ``devices=True`` (the default) puts the ranks on the cards, as
    ``run_ranks(devices=True)`` does, and raises when there is none;
    ``device_map`` overrides it (a callable rank -> torch.device or
    LogicalDevice, the same for every session).  ``window_us``, when
    given, sets ``dvm_batch_window_us`` for the sessions' life.  The
    resident-session hint is k while they run and 0 after; the knob is
    restored.  A session that fails raises its first rank's error
    after every session has ended."""
    if device_map is None and devices:
        device_map = _card_map()
    results: List[Optional[List[Any]]] = [None] * k
    errors: List[Optional[BaseException]] = [None] * k

    def session(s: int) -> None:
        try:
            results[s] = run_ranks(n, fn, timeout=timeout,
                                   device_map=device_map, cid_band=s + 1)
        except BaseException as e:  # noqa: BLE001
            errors[s] = e

    saved = registry.get("dvm_batch_window_us")
    if window_us is not None:
        registry.set("dvm_batch_window_us", int(window_us))
    fusion.set_xsession_hint(k)
    try:
        threads = [threading.Thread(target=session, args=(s,), daemon=True,
                                    name=f"session-{s + 1}")
                   for s in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        fusion.set_xsession_hint(0)
        registry.set("dvm_batch_window_us", saved)
    for e in errors:
        if e is not None:
            raise e
    return results


def doctor_capture(world, sid: int = 0, tid: int = 0, run_ms: int = 0,
                   est_ms: int = 0, factor_pct: int = 0,
                   health=None) -> Dict[str, Any]:
    """A hang-doctor capture of the thread world ``world`` (an
    ``InprocWorld`` whose rank threads ``run_ranks`` started), in the
    reference pool's document shape (``ompi_tpu/tools/dvm.py``
    ``_doctor_capture``): the stacks of this world's rank threads
    (``world.threads``, keyed by thread name; the threads of other
    worlds running at the same time are not read); every
    ``("coll_rv", cid, group)`` rendezvous of ``world.shared`` someone
    has arrived at, with its arrivals (``Rendezvous.snapshot``), cid
    and group; the aborted ranks; the flight recorder's last 64 events;
    ``host_health`` from ``health`` (a ``obs.health.HealthPlane``, or
    None); the integrity plane's conviction rows; and the placement,
    each rank's host (its ``rte.node_id``, 0 where none).  The
    session's id, request trace id and timing are the caller's (a
    thread world has no pool estimate); its namespace is ``s<sid>``.
    The KV fences stay empty: a thread world fences in memory, not
    through the KV store.  Cold path: run
    it off the ranks' threads, while they are wedged."""
    from ompi_tpu_torch.obs import integrity
    stacks: Dict[str, List[str]] = {}
    frames = sys._current_frames()
    for t in world.threads:
        fr = frames.get(t.ident)
        if fr is not None:
            stacks[t.name] = traceback.format_stack(fr)
    with world.shared_lock:
        rvs = [(k, v) for k, v in world.shared.items()
               if isinstance(k, tuple) and k and k[0] == "coll_rv"]
    rdvs: List[dict] = []
    for k, rv in rvs:
        snap = rv.snapshot()
        if snap["count"]:
            # only meetings someone has arrived at: an idle rendezvous
            # names every rank absent and would drown the verdict
            snap["cid"] = k[1]
            snap["group"] = list(k[2])
            rdvs.append(snap)
    placement = [int(getattr(getattr(st, "rte", None), "node_id", 0) or 0)
                 if st is not None else 0 for st in world.states]
    return {
        "sid": sid, "tid": tid, "span": 0, "ns": f"s{sid}",
        "np": world.size, "run_ms": run_ms, "est_ms": est_ms,
        "factor_pct": factor_pct, "mttd_ms": 0.0,
        "aborted": list(world.aborted) if world.aborted else None,
        "stacks": stacks,
        "rendezvous": rdvs,
        "fences": {},
        "events": obs.recorder().snapshot(64),
        "host_health": health.snapshot() if health is not None else None,
        "sdc": integrity.convicted_snapshot(),
        "placement": placement,
    }


def poison(world, code: int = 1, why: str = "poisoned") -> None:
    """Abort the thread world ``world`` from outside its rank threads:
    every blocking fence and rendezvous of that world raises at its
    next abort check, the ``rdv_sever`` wedge included, and ranks parked
    on their progress engines are woken.  The aborter is rank -1, so no
    rank of the world is exempt from its own check."""
    if world.aborted is None:
        world.aborted = (-1, code, why)
    for st in world.states:
        if st is not None and getattr(st, "progress", None) is not None:
            st.progress.wakeup()
