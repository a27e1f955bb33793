"""Thread-rank world harness.

Runs N MPI ranks as threads in one process — the execution model of
the reference package (one process drives all local cards; ranks map
to devices, several of them may share one card) and the fast path for
exercising the full stack in tests, mirroring how the reference tests
mapping logic without a cluster via ras/simulator
(ref: orte/mca/ras/simulator/ras_sim_module.c:67-91).
"""

from __future__ import annotations

import threading
import traceback
from typing import Any, Callable, List, Optional

from ompi_tpu_torch.runtime.init import mpi_finalize, mpi_init
from ompi_tpu_torch.runtime.rte import InprocWorld
from ompi_tpu_torch.runtime.state import LogicalDevice, ProcState


class RankError(RuntimeError):
    def __init__(self, rank: int, exc: BaseException, tb: str) -> None:
        super().__init__(f"rank {rank} failed: {exc}\n{tb}")
        self.rank = rank
        self.exc = exc


def _card_map() -> Callable:
    """rank -> torch.device("cuda", rank % card count).  Raises when
    no card is present: the device entry point never runs on the
    CPU unless the caller asks for it with an explicit device_map."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "run_ranks(devices=True) needs a CUDA card and none is "
            "available; pass device_map=lambda r: torch.device('cpu') "
            "to run the ranks on the CPU")
    ncard = torch.cuda.device_count()
    return lambda r: torch.device("cuda", r % ncard)


def logical_devices(device) -> Callable:
    """A ``device_map`` that gives rank r logical slot r on ``device``:
    n ranks on n distinct logical devices of one torch device, so
    their communicators take the mesh tier (coll/tpu) — on the CPU
    with the kernels' plain versions (``"cpu"``), or on one card with
    the kernels (``"cuda:0"``)."""
    import torch

    dev = torch.device(device)
    return lambda r: LogicalDevice(dev, r)


def run_ranks(n: int, fn: Callable, devices: bool = False,
              timeout: float = 120.0, device_map=None,
              cid_band: int = 0) -> List[Any]:
    """Run fn(comm_world) on n thread-ranks; returns per-rank results.

    devices=True maps rank i to torch.device("cuda", i % ncards): with
    n <= ncards every rank owns its own card (the mesh tier, coll/tpu),
    with one card every rank shares it (coll/hbm).  device_map
    overrides: a callable rank -> torch.device or LogicalDevice (e.g.
    lambda r: torch.device("cuda", 0) to co-locate every rank on one
    card, lambda r: torch.device("cpu") to run the device path on the
    CPU with the kernels' plain versions, or logical_devices("cpu") /
    logical_devices("cuda:0") for a mesh of logical devices).
    ``cid_band``: the world's session cid band (its communicators' ids
    start at cid_band * SESSION_CID_STRIDE; see testing.sessions)."""
    world = InprocWorld(n)
    results: List[Any] = [None] * n
    errors: List[Optional[RankError]] = [None] * n
    if device_map is None and devices:
        device_map = _card_map()

    def runner(rank: int) -> None:
        try:
            rte = world.make_rte(rank)
            state = ProcState(rank, n, rte)
            state.cid_band = cid_band
            world.states[rank] = state
            dev = device_map(rank) if device_map is not None else None
            mpi_init(state, device=dev)

            def _abort_check() -> int:
                if world.aborted and world.aborted[0] != rank:
                    raise RuntimeError(
                        f"peer rank {world.aborted[0]} aborted: "
                        f"{world.aborted[2]}")
                return 0

            state.progress.register(_abort_check, low_priority=True)
            results[rank] = fn(state.comm_world)
            # finalize only on success: its fence would deadlock
            # against peers that died before reaching it
            mpi_finalize(state)
        except BaseException as e:  # noqa: BLE001
            errors[rank] = RankError(rank, e, traceback.format_exc())
            if world.aborted is None:
                world.aborted = (rank, 1, str(e))
            for st in world.states:
                if st is not None:
                    st.progress.wakeup()

    threads = [threading.Thread(target=runner, args=(r,), daemon=True,
                                name=f"mpi-rank-{r}") for r in range(n)]
    world.threads = threads
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        if t.is_alive():
            raise TimeoutError(
                f"rank thread {t.name} did not finish within {timeout}s "
                f"(likely deadlock); errors so far: "
                f"{[e for e in errors if e]}")
    # surface the root cause: the rank that aborted first, not the
    # peers that failed reacting to the abort
    if world.aborted is not None and errors[world.aborted[0]] is not None:
        raise errors[world.aborted[0]]
    for e in errors:
        if e is not None:
            raise e
    return results
