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
import time
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
              cid_band: int = 0, allow_failures: bool = False,
              respawn: bool = False) -> List[Any]:
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
    start at cid_band * SESSION_CID_STRIDE; see testing.sessions).

    allow_failures=True treats a rank dying with ulfm.RankKilled as
    the scenario, not an error: its failure is published ULFM-style
    (survivors get ERR_PROC_FAILED and may revoke/agree/shrink), its
    result slot stays None, and only survivor errors raise.

    respawn=True is the thread-world analog of mpirun's respawn
    policy (ft/respawn): a RankKilled death is published like
    allow_failures, then its supervision loop waits for the survivors' rejoin
    decision (respawn.thread_decision) and starts a REPLACEMENT
    thread under the same world rank, bound to the dead rank's device
    (``device_map(rank)``) — a fresh ProcState flagged
    respawn_joining at the failure's epoch, with its own thread and
    so its own current streams.  fn runs again on the replacement
    (applications branch on respawn.joining(state) to rejoin +
    restore instead of starting over) and its return value fills the
    rank's result slot.  Kills reaped in the same window are replaced
    in ONE rejoin epoch (the decision's failed set); kills that land
    later take sequential epochs."""
    world = InprocWorld(n)
    results: List[Any] = [None] * n
    errors: List[Optional[RankError]] = [None] * n
    if device_map is None and devices:
        device_map = _card_map()
    respawn_cv = threading.Condition()
    respawn_q: List[int] = []  # killed ranks awaiting replacement

    def runner(rank: int, joining_epoch: Optional[int] = None) -> None:
        state = None
        try:
            rte = world.make_rte(rank)
            state = ProcState(rank, n, rte)
            state.cid_band = cid_band
            if joining_epoch is not None:
                # replacement rank: mpi_init must not re-arm the fault
                # that killed the predecessor, and the app must see
                # respawn.joining(state) truthy
                state.respawn_joining = True
                state.respawn_epoch = joining_epoch - 1
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
            if allow_failures or respawn:
                from ompi_tpu_torch.ft import ulfm as _ulfm
                if isinstance(e, _ulfm.RankKilled):
                    # the injected death IS the test scenario: the
                    # rank is gone, survivors mitigate via ULFM.  Mark
                    # the corpse for process-wide accounting (the
                    # coll.device dispatcher's last-rank drain):
                    # whatever raised RankKilled, this incarnation
                    # will never run mpi_finalize
                    if state is not None:
                        state.ulfm_dead = True
                    _ulfm.publish_world_failure(world, rank)
                    if respawn:
                        with respawn_cv:
                            respawn_q.append(rank)
                            respawn_cv.notify_all()
                    return
            errors[rank] = RankError(rank, e, traceback.format_exc())
            if world.aborted is None:
                world.aborted = (rank, 1, str(e))
            for st in world.states:
                if st is not None:
                    st.progress.wakeup()

    def _spawn(rank: int,
               joining_epoch: Optional[int] = None) -> threading.Thread:
        t = threading.Thread(
            target=runner, args=(rank, joining_epoch), daemon=True,
            name=f"mpi-rank-{rank}" if joining_epoch is None
            else f"mpi-rank-{rank}-e{joining_epoch}")
        world.threads.append(t)
        t.start()
        return t

    live = {r: _spawn(r) for r in range(n)}

    if respawn:
        # supervision loop (the inproc analog of mpirun's respawn
        # branch): reap kills, wait out each epoch's rejoin decision,
        # start the replacements, until every rank thread has finished.
        # Kills that land in the same reap window ride ONE epoch.  The
        # survivors' union can also decide ranks whose kill has not
        # reached this loop yet; those are remembered in `owed` so
        # the late queue entry does not double-respawn them.
        from ompi_tpu_torch.ft import respawn as _respawn
        deadline = time.monotonic() + timeout
        epoch = 0
        owed: set = set()
        while True:
            alive = any(t.is_alive() for t in live.values())
            with respawn_cv:
                pending, respawn_q[:] = list(respawn_q), []
            batch = [r for r in pending if r not in owed]
            owed.difference_update(pending)
            if batch:
                epoch += 1
                d = _respawn.thread_decision(
                    world, epoch,
                    timeout=max(1.0, deadline - time.monotonic()))
                decided = sorted(int(x) for x in d["failed"])
                owed.update(r for r in decided if r not in batch)
                for rank in decided:
                    live[rank] = _spawn(rank, joining_epoch=epoch)
            if not alive and not batch:
                break
            if world.aborted is not None and not pending:
                # a real error (not a kill): let the join path below
                # surface it instead of spinning to the deadline
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"respawn world did not finish within {timeout}s "
                    f"(epoch {epoch}); errors so far: "
                    f"{[e for e in errors if e]}")
            time.sleep(0.002)

    for t in live.values():
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


def mpirun_run(np_, prog, *args, devices=None, rpp=None, mca=(),
               extra=(), timeout=120, job_timeout=90, cwd=None, env=None):
    """Run ``prog`` under the port's mpirun
    (``python -m ompi_tpu_torch.tools.mpirun``) as a subprocess and
    return the CompletedProcess — the shared recipe for launcher tests
    (PYTHONPATH for the children, a job timeout inside a subprocess
    timeout).  ``devices`` is mpirun's ``--devices`` (auto, cpu or
    none; None leaves mpirun's default, auto) and ``rpp`` its
    ``--ranks-per-proc``; the caller chooses both, nothing here picks
    the CPU.  ``prog`` is absolute or relative to the checkout."""
    import os
    import subprocess
    import sys

    import ompi_tpu_torch as _pkg
    repo = os.path.dirname(os.path.dirname(os.path.abspath(
        _pkg.__file__)))
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun",
           "-np", str(np_)]
    if rpp is not None:
        cmd += ["--ranks-per-proc", str(rpp)]
    if devices is not None:
        cmd += ["--devices", devices]
    if job_timeout:
        cmd += ["--timeout", str(job_timeout)]
    for k, v in mca:
        cmd += ["--mca", k, str(v)]
    cmd += [*extra, prog if os.path.isabs(prog)
            else os.path.join(repo, prog), *args]
    full = dict(os.environ if env is None else env)
    full["PYTHONPATH"] = repo + os.pathsep + full.get("PYTHONPATH", "")
    return subprocess.run(cmd, capture_output=True, timeout=timeout,
                          env=full, cwd=cwd or repo)


def collseg_digest(nranks: int, seed: int = 20261018) -> str:
    """The ``SEGDIGEST`` every rank of ``examples/collseg_prog.py``
    prints at ``nranks`` process ranks: sha256 over numpy's rank-order
    reductions (SUM, MAX, BXOR) of the program's seeded int64 draws,
    then its Bcast and Allgather results — the reference semantics,
    byte for byte the p2p route's."""
    import hashlib

    import numpy as np
    h = hashlib.sha256()
    for k, red in enumerate((np.add, np.maximum, np.bitwise_xor)):
        xs = [np.random.default_rng(seed + 31 * k + r).integers(
            0, 1 << 40, 1 << 17) for r in range(nranks)]
        h.update(red.reduce(np.stack(xs), axis=0).tobytes())
    h.update(np.random.default_rng(seed + 7).integers(
        0, 1 << 40, 4099).tobytes())
    h.update(np.concatenate([np.random.default_rng(seed + 11 + r).integers(
        0, 1 << 40, 33) for r in range(nranks)]).tobytes())
    return h.hexdigest()
