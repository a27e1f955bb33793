"""orte-restart analog: relaunch a checkpointed job from its store.

Port of the reference's tools/restart.py: it re-execs the port's
mpirun.

``mpirun --ckpt-dir DIR`` records job.json (np/prog/args/mca) in the
store; this tool re-execs mpirun with ``--restart DIR`` so the app's
``cr.restore(comm)`` resumes from the latest complete snapshot
(ref: orte/tools/orte-restart/orte-restart.c — reads the snapshot
handle's metadata and builds the orterun command line).

    python -m ompi_tpu_torch.tools.restart DIR [extra mpirun args...]
"""

from __future__ import annotations

import json
import os
import sys
from typing import List, Optional


def build_cmd(store_dir: str, extra: List[str]) -> List[str]:
    with open(os.path.join(store_dir, "job.json")) as f:
        job = json.load(f)
    cmd = [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun",
           "-np", str(job["np"]), "--restart", store_dir]
    # replay the recorded allocation + placement (older job.json
    # files lack these keys: local launch, byslot)
    if job.get("hosts"):
        cmd += ["--hosts", job["hosts"]]
    if job.get("hostfile"):
        cmd += ["--hostfile", job["hostfile"]]
    if job.get("simulate"):
        cmd += ["--simulate-nodes", job["simulate"]]
    if job.get("map_by") and job["map_by"] != "byslot" \
            and not any(a == "--map-by" for a in extra):
        cmd += ["--map-by", job["map_by"]]
    if job.get("oversubscribe"):
        cmd += ["--oversubscribe"]
    for k, v in job.get("mca") or []:
        cmd += ["--mca", k, v]
    # always explicit: mpirun's default is "all" (hybrid), so an
    # rpp=1 job silently changing execution model on restart would
    # break snapshot/rank identity assumptions
    cmd += ["--ranks-per-proc", str(job.get("rpp", 1))]
    if job.get("devices"):
        # the rank-threads' devices, as launched (a record without the
        # key takes mpirun's default)
        cmd += ["--devices", job["devices"]]
    if job.get("preload"):
        cmd += ["--preload"]
    cmd += extra
    cmd += [job["prog"]] + list(job.get("args") or [])
    return cmd


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        sys.stderr.write(__doc__)
        return 2
    store_dir = os.path.abspath(argv[0])
    if not os.path.exists(os.path.join(store_dir, "job.json")):
        sys.stderr.write(
            f"restart: no job.json in {store_dir} (was the job "
            "launched with mpirun --ckpt-dir?)\n")
        return 2
    import subprocess
    return subprocess.call(build_cmd(store_dir, argv[1:]))


if __name__ == "__main__":
    sys.exit(main())
