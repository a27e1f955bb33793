"""Runtime-environment abstraction: the contract the MPI layer needs
from any runtime.

This mirrors the reference's rte interface spec exactly
(ref: ompi/mca/rte/rte.h:35-145): process naming, modex put/get
(business-card exchange), barrier/fence, abort, and init/finalize.
Implementations:

  * InprocRTE — thread-ranks inside one host process (the co-located
    ranks of one card; also the fast test harness).  Modex is a
    shared dict, fence a survivor-counting barrier.
  * EnvRTE — process-ranks launched by ompi_tpu_torch.tools.mpirun;
    modex and fence go through the launcher's KV store over TCP (the
    PMIx-like put/commit/fence, ref: opal/mca/pmix usage in
    ompi_mpi_init.c:654-661).
  * HybridRTE — the rank-threads of one app shell
    (ompi_tpu_torch.tools.hostrun): EnvRTE's KV store for the job, a
    HybridWorld shared with the shell's other rank-threads for the
    inproc btl and the device rendezvous.
"""

from __future__ import annotations

import os
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


class HybridWorld(InprocWorld):
    """Shared state for the hybrid launch model: one process (app
    shell) owning a contiguous block of rank-threads, with more such
    processes elsewhere in the job.  ``states`` is indexed by GLOBAL
    rank — entries for ranks of other shells stay None, which is what
    makes comm.mesh() and coll/hbm refuse communicators that span
    shells (they take the host path, staged through pinned memory)."""

    def __init__(self, world_size: int, rank_base: int, nlocal: int) -> None:
        super().__init__(nlocal)
        self.size = world_size
        self.rank_base = rank_base
        self.nlocal = nlocal
        self.states = [None] * world_size
        # global fences go through the KV server (EnvRTE.fence); the
        # inherited survivor-counting fence is never used here

    def is_local(self, rank: int) -> bool:
        return self.rank_base <= rank < self.rank_base + self.nlocal


class EnvRTE(RTE):
    """Process-rank runtime: identity from the environment set by the
    launcher (ompi_tpu_torch.tools.mpirun), modex/fence through its KV
    server (ref: orte/mca/ess env component + pmix client)."""

    def __init__(self) -> None:
        from .kvstore import KVClient  # noqa: PLC0415

        self.rank = int(os.environ["TPUMPI_RANK"])
        # world = this job's ranks; universe = every rank launched so
        # far (dpm: spawned jobs extend the universe, ref: ompi/dpm).
        # `size` is the universe extent — it sizes endpoint tables so
        # dynamic peers are addressable; comm_world uses world_base/
        # world_size.
        self.world_size = int(os.environ.get(
            "TPUMPI_WORLD_SIZE", os.environ["TPUMPI_SIZE"]))
        self.world_base = int(os.environ.get("TPUMPI_WORLD_BASE", "0"))
        self.size = int(os.environ.get(
            "TPUMPI_UNIVERSE", os.environ["TPUMPI_SIZE"]))
        self.parent_root = os.environ.get("TPUMPI_PARENT_ROOT")
        self.appnum = int(os.environ.get("TPUMPI_APPNUM", "0"))
        self.jobid = os.environ.get("TPUMPI_JOBID", "job0")
        self.node_id = int(os.environ.get("TPUMPI_NODE", "0"))
        self.session_dir = os.environ.get("TPUMPI_SESSION_DIR", "/tmp")
        self.kv = KVClient(os.environ["TPUMPI_KV_ADDR"])
        self._fence_count = 0
        # live recovery: a restarted rank joins the job at a bumped
        # epoch — its fences and modex keys live in the epoch
        # namespace so a write-once modex cache can never serve
        # pre-failure values
        self.modex_epoch = int(os.environ.get("TPUMPI_FT_EPOCH", "0"))
        if self.modex_epoch:
            self.jobid_base = self.jobid
            self.jobid = f"{self.jobid}:e{self.modex_epoch}"

    def modex_put(self, key: str, value: Any) -> None:
        e = getattr(self, "modex_epoch", 0)
        sfx = f"@e{e}" if e else ""
        self.kv.put(f"modex:{self.rank}:{key}{sfx}", value)

    def modex_get(self, peer: int, key: str) -> Any:
        e = getattr(self, "modex_epoch", 0)
        sfx = f"@e{e}" if e else ""
        return self.kv.get(f"modex:{peer}:{key}{sfx}",
                           timeout=_modex_timeout_var.value)

    def fence(self) -> None:
        # namespaced by job and sized to the job's world: spawned
        # jobs fence among themselves, never with the parent job.
        # ULFM-declared dead ranks never arrive — shrink the quorum so
        # survivor fences complete (the KV server honors per-message
        # weights)
        self._fence_count += 1
        dead = sum(1 for r in getattr(self, "ulfm_failed", ())
                   if self.world_base <= r <
                   self.world_base + self.world_size)
        self.kv.fence(f"{self.jobid}:f{self._fence_count}",
                      n=self.world_size - dead)

    def abort(self, code: int, msg: str = "") -> None:
        import sys

        self.kv.abort(self.rank, code, msg)
        sys.stderr.write(f"[rank {self.rank}] MPI_Abort({code}): {msg}\n")
        sys.stderr.flush()
        os._exit(code)

    def finalize(self) -> None:
        self.kv.close()


class HybridRTE(EnvRTE):
    """Rank-thread runtime for the hybrid launch model: global modex /
    fence / abort through the launcher's KV server (EnvRTE behavior),
    plus a HybridWorld shared with co-resident rank-threads so the
    inproc btl and the device-collective rendezvous work across them.
    The per-host app shell (ompi_tpu_torch.tools.hostrun) builds one of
    these per rank-thread (ref: the per-node orted owning its local
    procs, orte/orted/orted_main.c — except local 'procs' are threads
    driving local cards)."""

    def __init__(self, world: HybridWorld, rank: int, kv_addr: str,
                 node_id: int = 0, jobid: str = "job0",
                 session_dir: str = "/tmp",
                 kv_ns: Optional[str] = None) -> None:
        from .kvstore import KVClient  # noqa: PLC0415

        # no super().__init__(): identity comes from the app shell's
        # arguments, not per-process env vars (threads share env).
        # kv_ns scopes every KV key (modex, fences, ULFM notes) under
        # a session namespace
        self.world = world
        self.rank = rank
        self.size = world.size
        self.world_base = 0
        self.world_size = world.size
        self.jobid = jobid
        self.node_id = node_id
        self.session_dir = session_dir
        self.kv = KVClient(kv_addr, ns=kv_ns)
        self.default_device: Any = None
        self._fence_count = 0

    def abort(self, code: int, msg: str = "") -> None:
        # flag local rank-threads first so parked rendezvous/progress
        # loops see the abort before the process dies
        self.world.aborted = (self.rank, code, msg)
        for st in self.world.states:
            if st is not None and getattr(st, "progress", None) is not None:
                st.progress.wakeup()
        EnvRTE.abort(self, code, msg)


_tls_rte = threading.local()


def set_thread_rte(rte: Optional[RTE]) -> None:
    """Install the RTE the next make_rte() on THIS thread returns —
    the hook the hostrun app shell uses to hand each rank-thread its
    pre-built HybridRTE before running the user program."""
    _tls_rte.rte = rte


def make_rte() -> RTE:
    """Bootstrap this process's runtime (ess component selection
    analog, ref: orte/mca/ess): app-shell rank-thread → injected
    HybridRTE; launched by our mpirun → EnvRTE; standalone →
    singleton world of size 1."""
    injected = getattr(_tls_rte, "rte", None)
    if injected is not None:
        return injected
    if "TPUMPI_KV_ADDR" in os.environ:
        return EnvRTE()
    world = InprocWorld(1)
    return world.make_rte(0)
