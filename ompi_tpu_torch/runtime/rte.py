"""Runtime-environment abstraction: the contract the MPI layer needs
from any runtime.

This mirrors the reference's rte interface spec exactly
(ref: ompi/mca/rte/rte.h:35-145): process naming, modex put/get
(business-card exchange), barrier/fence, abort, and init/finalize.
The port carries one implementation so far:

  * InprocRTE — thread-ranks inside one host process (the co-located
    ranks of one card; also the fast test harness).  Modex is a
    shared dict, fence a survivor-counting barrier.

The launcher RTEs (EnvRTE, HybridRTE) are not ported yet.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional, Set

from ompi_tpu_torch.mca.params import registry

_modex_timeout_var = registry.register(
    "rte", "base", "modex_timeout", 30.0, float,
    help="Seconds a modex_get waits for a peer's business card "
         "before failing (raise under debuggers / huge jobs)")
_fence_timeout_var = registry.register(
    "rte", "base", "fence_timeout", 60.0, float,
    help="Seconds a fence waits for all ranks before failing")


class RTE:
    rank: int
    size: int

    def modex_put(self, key: str, value: Any) -> None:
        raise NotImplementedError

    def modex_get(self, peer: int, key: str) -> Any:
        raise NotImplementedError

    def fence(self) -> None:
        raise NotImplementedError

    def abort(self, code: int, msg: str = "") -> None:
        raise NotImplementedError

    def finalize(self) -> None:
        pass


class InprocWorld:
    """Shared state for an N-thread-rank world on one host."""

    def __init__(self, size: int) -> None:
        self.size = size
        self.modex: Dict[tuple, Any] = {}
        self.modex_cv = threading.Condition()
        self.states: List[Any] = [None] * size  # ProcState per rank
        self.aborted: Optional[tuple] = None
        # the world's rank threads, set by whoever starts them
        # (testing.run_ranks): the hang doctor reads their stacks
        self.threads: List[threading.Thread] = []
        # shared rendezvous objects for device collectives (coll/hbm),
        # keyed by communicator cid
        self.shared: Dict[Any, Any] = {}
        self.shared_lock = threading.Lock()
        # ULFM (ompi_tpu_torch/ft/ulfm): global ranks declared
        # permanently dead.  Fences count survivors only, so a kill
        # shrinks the quorum instead of hanging every later fence
        self.ulfm_failed: Set[int] = set()
        self._f_cv = threading.Condition()
        self._f_count = 0
        self._f_gen = 0

    def fence(self, rank: int, timeout: float) -> None:
        """Generation-counting barrier over the SURVIVORS: the quorum
        is recomputed on every wake, so a rank dying while others are
        parked here shrinks it and releases them (a threading.Barrier's
        party count is frozen at construction).  The short wait slices
        double as an abort poll: a peer that errors out releases
        everyone."""
        with self._f_cv:
            gen = self._f_gen
            self._f_count += 1
            deadline = time.monotonic() + timeout
            while gen == self._f_gen:
                if self.aborted is not None and self.aborted[0] != rank:
                    raise RuntimeError(
                        f"peer rank {self.aborted[0]} aborted: "
                        f"{self.aborted[2]}")
                if self._f_count >= self.size - len(self.ulfm_failed):
                    self._f_count = 0
                    self._f_gen += 1
                    self._f_cv.notify_all()
                    return
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"fence timed out (rank {rank})")
                self._f_cv.wait(timeout=min(left, 0.05))

    def is_local(self, rank: int) -> bool:
        """Is `rank` a thread in this process (inproc-btl reachable,
        device-rendezvous capable)?"""
        return 0 <= rank < self.size

    def make_rte(self, rank: int) -> "InprocRTE":
        return InprocRTE(self, rank)


class InprocRTE(RTE):
    def __init__(self, world: InprocWorld, rank: int) -> None:
        self.world = world
        self.rank = rank
        self.size = world.size

    def modex_put(self, key: str, value: Any) -> None:
        with self.world.modex_cv:
            self.world.modex[(self.rank, key)] = value
            self.world.modex_cv.notify_all()

    def modex_get(self, peer: int, key: str) -> Any:
        with self.world.modex_cv:
            while (peer, key) not in self.world.modex:
                if self.world.aborted:
                    raise RuntimeError(f"job aborted: {self.world.aborted}")
                if not self.world.modex_cv.wait(
                        timeout=_modex_timeout_var.value):
                    raise TimeoutError(
                        f"modex_get({peer},{key}) timed out")
            return self.world.modex[(peer, key)]

    def fence(self) -> None:
        self.world.fence(self.rank, _fence_timeout_var.value)

    def abort(self, code: int, msg: str = "") -> None:
        self.world.aborted = (self.rank, code, msg)
        with self.world.modex_cv:
            self.world.modex_cv.notify_all()
        raise SystemExit(code)
