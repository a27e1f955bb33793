"""orte-migrate analog: restart a checkpointed job with ranks MOVED.

Port of the reference's tools/migrate.py: it re-execs the port's
mpirun.

Re-design of orte/tools/orte-migrate (orte-migrate.c:1 — ask the
HNP's errmgr to checkpoint a running job and restart specific procs
on different nodes).  Our C/R stack is store-based, so migration is
a placement-overridden restart: read the launch record (job.json),
recompute the original rank->node placement, apply the requested
moves, write the result as a RANKFILE into the store, and re-exec
mpirun with ``--restart DIR --map-by rankfile:...``.  The app's
``cr.restore(comm)`` resumes from the latest complete snapshot with
the moved ranks living on their new nodes — rank identity, sequence
spaces and snapshot files are placement-independent (rank_N.ckpt),
so nothing else changes.

    python -m ompi_tpu_torch.tools.migrate DIR --move R=NODE [--move ...] \
        [extra mpirun args...]

NODE is a node name from the job's allocation (e.g. ``sim2`` for
--simulate-nodes jobs, a hostname for --hosts jobs).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Tuple


def plan_migration(store_dir: str,
                   moves: Dict[int, str]) -> Tuple[List[str], str]:
    """Build the relaunch command + rankfile.  Returns (cmd, rankfile
    text) without touching the filesystem beyond reads (testable)."""
    with open(os.path.join(store_dir, "job.json")) as f:
        job = json.load(f)

    rpp = job.get("rpp", 1)
    if rpp not in (1, "1"):
        raise ValueError(
            "migration is per-RANK and needs one process per rank; "
            "this job ran with --ranks-per-proc "
            f"{rpp!r} (thread-ranks share a process and move only "
            "together) — relaunch with --ranks-per-proc 1 to make "
            "it migratable")

    from ompi_tpu_torch.runtime import ras, rmaps
    nodes = ras.allocate(job.get("hosts"), job.get("hostfile"),
                         job.get("simulate"), job["np"])
    by_name = {n.name for n in nodes}
    for r, name in moves.items():
        if not 0 <= r < job["np"]:
            raise ValueError(f"--move: rank {r} out of range for "
                             f"-np {job['np']}")
        if name not in by_name:
            raise ValueError(
                f"--move: unknown node {name!r} (allocation has "
                f"{sorted(by_name)})")

    # the CURRENT placement, then override: a prior migration's
    # rankfile (if any) is the effective placement — recomputing from
    # the original policy would silently move earlier-migrated ranks
    # back onto the nodes they were moved off
    placement: Dict[int, str] = {}
    prior = os.path.join(store_dir, "migrate.rankfile")
    if os.path.exists(prior):
        with open(prior) as f:
            for line in f:
                line = line.strip()
                if line.startswith("rank") and "=" in line:
                    rpart, npart = line[4:].split("=", 1)
                    placement[int(rpart.strip())] = npart.strip()
    else:
        maps = rmaps.map_ranks(nodes, job["np"], 1,
                               policy=job.get("map_by", "byslot"),
                               oversubscribe=True)
        for m in maps:
            for p in m.procs:
                # nlocal == 0 encodes a classic one-rank process
                for r in range(p.rank_base,
                               p.rank_base + max(1, p.nlocal)):
                    placement[r] = m.node.name
    placement.update(moves)
    lines = [f"rank {r}={placement[r]}" for r in sorted(placement)]
    rankfile = "\n".join(lines) + "\n"

    rf_path = os.path.join(store_dir, "migrate.rankfile")
    # moving ranks onto surviving nodes oversubscribes them by
    # definition (orte-migrate's whole point is running without the
    # lost capacity)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun",
           "-np", str(job["np"]), "--restart", store_dir,
           "--map-by", f"rankfile:{rf_path}", "--oversubscribe"]
    if job.get("hosts"):
        cmd += ["--hosts", job["hosts"]]
    if job.get("hostfile"):
        cmd += ["--hostfile", job["hostfile"]]
    if job.get("simulate"):
        cmd += ["--simulate-nodes", job["simulate"]]
    for k, v in job.get("mca") or []:
        cmd += ["--mca", k, v]
    cmd += ["--ranks-per-proc", "1"]
    if job.get("devices"):
        cmd += ["--devices", job["devices"]]
    if job.get("preload"):
        cmd += ["--preload"]
    cmd += [job["prog"]] + list(job.get("args") or [])
    return cmd, rankfile


def plan_evacuation(store_dir: str,
                    node: str) -> Tuple[List[str], str, Dict[int, str]]:
    """Gray-failure drain (DESIGN.md §24): move EVERY rank of a
    degraded/quarantined node onto the remaining allocation nodes,
    round-robin — the whole-host analog of --move, so the operator
    acting on a `straggler` doctor verdict (or a quarantine event)
    types one node name instead of N rank moves.  Returns (cmd,
    rankfile text, the computed moves); pure beyond reads."""
    with open(os.path.join(store_dir, "job.json")) as f:
        job = json.load(f)
    from ompi_tpu_torch.runtime import ras, rmaps
    nodes = ras.allocate(job.get("hosts"), job.get("hostfile"),
                         job.get("simulate"), job["np"])
    names = [n.name for n in nodes]
    if node not in names:
        raise ValueError(f"--evacuate: unknown node {node!r} "
                         f"(allocation has {sorted(names)})")
    targets = [n for n in names if n != node]
    if not targets:
        raise ValueError("--evacuate: no healthy node left to "
                         "receive the ranks")
    # effective placement: a prior migration's rankfile wins, else
    # the original mapping policy (same precedence as plan_migration)
    placement: Dict[int, str] = {}
    prior = os.path.join(store_dir, "migrate.rankfile")
    if os.path.exists(prior):
        with open(prior) as f:
            for line in f:
                line = line.strip()
                if line.startswith("rank") and "=" in line:
                    rpart, npart = line[4:].split("=", 1)
                    placement[int(rpart.strip())] = npart.strip()
    else:
        maps = rmaps.map_ranks(nodes, job["np"], 1,
                               policy=job.get("map_by", "byslot"),
                               oversubscribe=True)
        for m in maps:
            for p in m.procs:
                for r in range(p.rank_base,
                               p.rank_base + max(1, p.nlocal)):
                    placement[r] = m.node.name
    moves = {r: targets[i % len(targets)]
             for i, r in enumerate(sorted(
                 r for r, n in placement.items() if n == node))}
    if not moves:
        raise ValueError(f"--evacuate: no rank currently placed on "
                         f"{node!r}")
    cmd, rankfile = plan_migration(store_dir, moves)
    return cmd, rankfile, moves


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(__doc__)
        return 2
    store_dir = os.path.abspath(argv[0])
    if not os.path.exists(os.path.join(store_dir, "job.json")):
        sys.stderr.write(
            f"migrate: no job.json in {store_dir} (was the job "
            "launched with mpirun --ckpt-dir?)\n")
        return 2
    moves: Dict[int, str] = {}
    evacuate: Optional[str] = None
    extra: List[str] = []
    it = iter(argv[1:])
    for a in it:
        if a == "--move":
            try:
                spec = next(it)
                rpart, _, node = spec.partition("=")
                moves[int(rpart)] = node
            except (StopIteration, ValueError):
                sys.stderr.write("migrate: --move needs RANK=NODE\n")
                return 2
        elif a == "--evacuate":
            try:
                evacuate = next(it)
            except StopIteration:
                sys.stderr.write("migrate: --evacuate needs NODE\n")
                return 2
        else:
            extra.append(a)
    if not moves and not evacuate:
        sys.stderr.write("migrate: at least one --move RANK=NODE or "
                         "--evacuate NODE required (plain restart: "
                         "use ompi_tpu_torch.tools.restart)\n")
        return 2
    try:
        if evacuate:
            if moves:
                raise ValueError("--evacuate and --move are "
                                 "exclusive (evacuation computes the "
                                 "moves itself)")
            cmd, rankfile, moves = plan_evacuation(store_dir, evacuate)
        else:
            cmd, rankfile = plan_migration(store_dir, moves)
    except (ValueError, OSError) as e:
        sys.stderr.write(f"migrate: {e}\n")
        return 2
    rf_path = os.path.join(store_dir, "migrate.rankfile")
    with open(rf_path, "w") as f:
        f.write(rankfile)
    moved = ", ".join(f"rank {r} -> {n}"
                      for r, n in sorted(moves.items()))
    sys.stderr.write(f"migrate: {moved}\n")
    # insert any extra mpirun args before the prog+args block
    if extra:
        with open(os.path.join(store_dir, "job.json")) as f:
            job = json.load(f)
        tail = 1 + len(job.get("args") or [])
        cmd = cmd[:-tail] + extra + cmd[-tail:]
    import subprocess
    return subprocess.call(cmd)


if __name__ == "__main__":
    sys.exit(main())
