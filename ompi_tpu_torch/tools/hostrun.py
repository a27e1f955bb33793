"""hostrun: the per-host app shell of the hybrid launch model.

Port of the reference's tools/hostrun.py.  Ranks that share a card
meet inside one process (the device rendezvous is a shared object, the
card's kernels see every rank's tensor), so a "node" here runs its
ranks as threads of a single app-shell process — this module.  mpirun
--ranks-per-proc spawns one hostrun per block of ranks; hostrun builds
a HybridWorld, gives each rank-thread its device, injects a HybridRTE
per thread, and runs the user program in every thread via runpy (each
execution gets a fresh __main__ namespace).

This is the odls/orted analog: the reference's per-node daemon
fork/execs N processes (ref:
orte/mca/odls/default/odls_default_module.c:338-437); here the N
local "procs" share the process that owns the cards, so they are
rank-threads — which is what makes the device tiers (coll/hbm, the
mesh) reachable from a real launch.

Devices (TPUMPI_DEVICES, mpirun --devices):

  * ``auto`` — the cards: rank r gets ``torch.device("cuda", r %
    count)``, as the reference maps ``devices[rank % len(devices)]``.
    With no card the shell raises before any rank starts: a job asked
    for cards never runs on the CPU;
  * ``cpu`` — every rank on ``torch.device("cpu")`` (the kernels'
    plain versions), the explicit request the CPU tests make;
  * ``none`` — host-only ranks (no device).

A simulated node (mpirun --simulate-nodes NxM sets TPUMPI_SIM_NODES=N
and TPUMPI_SIM_DEVICES=M in its daemon's env) has M devices of its
own, handed to its ranks in node order: with ``auto``, M logical
devices of card ``n % count`` for node n (``runtime.state.
LogicalDevice``: ranks on distinct slots of one card form a mesh, so
the node's communicator takes the mesh tier), or M distinct cards when
the host has N × M of them; with ``cpu``, M logical devices of the
CPU.  The reference forces an M-device CPU platform there instead.

Rank deaths under mpirun's errmgr policies (TPUMPI_ULFM names the
policy): a rank-thread killed by ULFM's ``RankKilled`` (ft_inject
``rank_kill``, ``ulfm.kill_now``) is the thread analog of a rank
process dying.  Under ``ulfm`` the shell publishes the failure — to
its own rank-threads directly and to the other shells through a KV
failure note — and runs on with its survivors; under ``respawn`` the
shell is the unit the launcher replaces, so it exits at once and
mpirun relaunches it, every rank it held joining at the next epoch
(TPUMPI_RESPAWN, TPUMPI_FT_EPOCH).  Any other death reports an abort
and the job ends.

Env contract (set by mpirun or tpud): TPUMPI_SIZE, TPUMPI_RANK_BASE,
TPUMPI_LOCAL_RANKS, TPUMPI_KV_ADDR, TPUMPI_NODE, TPUMPI_NODE_RANK_BASE,
TPUMPI_JOBID, TPUMPI_SESSION_DIR, TPUMPI_DEVICES (auto|cpu|none),
TPUMPI_SIM_NODES and TPUMPI_SIM_DEVICES (simulated nodes only),
TPUMPI_ULFM, TPUMPI_RESPAWN and TPUMPI_FT_EPOCH (errmgr policies).
"""

from __future__ import annotations

import os
import runpy
import sys
import threading
import traceback
from typing import List, Optional, Tuple

from ompi_tpu_torch.runtime.rte import HybridRTE, HybridWorld, set_thread_rte
from ompi_tpu_torch.runtime.state import LogicalDevice


def shell_devices(choice: str,
                  sim: Optional[Tuple[int, int, int]] = None
                  ) -> Optional[list]:
    """The devices the shell's ranks take in turn: the cards for
    ``auto`` (raises when there is none), the CPU for ``cpu``, None for
    ``none``.  ``sim`` = (node, nodes, M) on a simulated node: that
    node's M devices (see the module docstring)."""
    if choice == "none":
        return None
    import torch
    if choice == "cpu":
        if sim is not None:
            return [LogicalDevice(torch.device("cpu"), s)
                    for s in range(sim[2])]
        return [torch.device("cpu")]
    if choice != "auto":
        raise ValueError(f"TPUMPI_DEVICES={choice!r}: auto, cpu or none")
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if count == 0:
        raise RuntimeError(
            "mpirun --devices auto: no CUDA card is visible to this app "
            "shell; no rank was started (run with --devices cpu to use "
            "the CPU, or --devices none for host-only ranks)")
    cards = [torch.device("cuda", i) for i in range(count)]
    if sim is None:
        return cards
    node, nodes, m = sim
    if count >= nodes * m:
        return cards[node * m:(node + 1) * m]
    return [LogicalDevice(cards[node % count], s) for s in range(m)]


def sim_node() -> Optional[Tuple[int, int, int]]:
    """(node, nodes, M) from a simulated node's env, else None."""
    m = int(os.environ.get("TPUMPI_SIM_DEVICES", "0"))
    if m < 1:
        return None
    return (int(os.environ.get("TPUMPI_NODE", "0")),
            int(os.environ.get("TPUMPI_SIM_NODES", "1")), m)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    prog, prog_args = argv[0], argv[1:]

    size = int(os.environ["TPUMPI_SIZE"])
    base = int(os.environ["TPUMPI_RANK_BASE"])
    nlocal = int(os.environ["TPUMPI_LOCAL_RANKS"])
    kv_addr = os.environ["TPUMPI_KV_ADDR"]
    node_id = int(os.environ.get("TPUMPI_NODE", "0"))
    jobid = os.environ.get("TPUMPI_JOBID", "job0")
    session = os.environ.get("TPUMPI_SESSION_DIR", "/tmp")
    policy = os.environ.get("TPUMPI_ULFM", "")
    epoch = int(os.environ.get("TPUMPI_FT_EPOCH", "0"))

    sim = sim_node()
    devices = shell_devices(os.environ.get("TPUMPI_DEVICES", "auto"), sim)
    # rank r takes entry r % len; a simulated node's devices go to its
    # own ranks in node order
    offset = int(os.environ.get("TPUMPI_NODE_RANK_BASE", "0")) \
        if sim is not None else 0

    world = HybridWorld(size, base, nlocal)
    failure: List[Optional[int]] = [None]
    flock = threading.Lock()

    def fail_rank(rank: int, rte, code: int, why: str) -> None:
        """The thread analog of a rank process dying: record it and
        report to the launcher so its errmgr policy kills the job —
        local peers may be parked in global KV fences that the
        in-process abort flag cannot reach."""
        with flock:
            failure[0] = failure[0] or code
        if world.aborted is None:
            world.aborted = (rank, code, why)
        for st in world.states:
            if st is not None and getattr(st, "progress", None):
                st.progress.wakeup()
        try:
            if rte is not None:
                rte.kv.abort(rank, code, why)
            else:  # setup died before the rte existed
                from ompi_tpu_torch.runtime.kvstore import KVClient

                kv = KVClient(kv_addr)
                kv.abort(rank, code, why)
                kv.close()
        except Exception:  # noqa: BLE001
            pass

    def rank_killed(rank: int) -> None:
        """A rank-thread died a ULFM death (see the module
        docstring)."""
        if policy == "respawn":
            sys.stderr.write(f"[rank {rank}] killed; app shell exits for "
                             f"the respawn policy to relaunch it\n")
            sys.stderr.flush()
            sys.stdout.flush()
            os._exit(1)
        from ompi_tpu_torch.ft import ulfm as _ulfm
        st = world.states[rank]
        if st is not None:
            _ulfm.publish_failure(st, rank)

    def run_rank(local_rank: int) -> None:
        rank = base + local_rank
        rte = None
        try:
            rte = HybridRTE(world, rank, kv_addr, node_id=node_id,
                            jobid=jobid, session_dir=session)
            if epoch:
                # a replacement shell of the respawn policy: its fences
                # and modex keys live in the epoch's namespace, as a
                # replacement process's (EnvRTE)
                rte.jobid_base, rte.jobid = jobid, f"{jobid}:e{epoch}"
                rte.modex_epoch = epoch
            if devices:
                rte.default_device = devices[(rank - offset) % len(devices)]
            set_thread_rte(rte)
            runpy.run_path(prog, run_name="__main__")
        except SystemExit as e:
            from ompi_tpu_torch.ft.ulfm import RankKilled
            if policy and isinstance(e, RankKilled):
                rank_killed(rank)
                return
            code = e.code if isinstance(e.code, int) else (
                0 if e.code is None else 1)
            if code != 0:
                fail_rank(rank, rte, code, f"rank exited with {code}")
        except BaseException as e:  # noqa: BLE001
            sys.stderr.write(f"[rank {rank}] uncaught exception:\n"
                             f"{traceback.format_exc()}")
            sys.stderr.flush()
            fail_rank(rank, rte, 1, f"uncaught exception: {e!r}")

    # argv seen by the user program (shared across rank-threads, like
    # every process-rank seeing the same argv)
    sys.argv = [prog] + prog_args
    threads = [threading.Thread(target=run_rank, args=(lr,), daemon=True,
                                name=f"mpi-rank-{base + lr}")
               for lr in range(nlocal)]
    world.threads = threads  # the hang doctor reads their stacks
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return failure[0] or 0


if __name__ == "__main__":
    sys.exit(main())
