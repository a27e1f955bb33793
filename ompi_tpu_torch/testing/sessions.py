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

On the CPU: ``device_map=lambda r: torch.device("cpu")`` (coll/hbm) or
``device_map=logical_devices("cpu")`` (the mesh tier), with the
kernels' plain versions.  On the card: the default (``devices=True``:
rank r of every session on ``cuda:(r % cards)``), or
``logical_devices("cuda:0")`` for a mesh of logical devices.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List, Optional

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
