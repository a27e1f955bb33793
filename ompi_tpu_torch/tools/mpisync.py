"""mpisync: cross-rank clock-offset measurement.

The port's copy of the reference's ``ompi_tpu/tools/mpisync.py`` (a
re-design of ompi/tools/mpisync, ref: ompi/tools/mpisync/sync.c —
Hunold/Träff-style clock synchronization run as an MPI program): rank
0 ping-pongs with every other rank over the port's pml; each exchange
timestamps both sides and estimates offset = remote_clock -
local_clock at minimum-RTT (the exchange least polluted by scheduling
noise).

``trace.sync_state`` calls ``measure_offsets`` at finalize and embeds
the table into every rank's trace dump, the input traceview and
critpath merge with.  In a thread world every rank reads one clock, so
the offsets are near zero; they ride the dumps all the same.

Run under mpirun:

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/tools/mpisync.py [--rounds N]

Rank 0 prints one line per rank: offset seconds + RTT, plus a JSON
summary.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Tuple

import numpy as np


def measure_offsets(comm, rounds: int = 50) -> List[Tuple[float, float]]:
    """Returns [(offset_s, rtt_s)] indexed by rank (rank 0 = (0, 0)).
    Offset converts a remote timestamp to rank-0 time:
    t0 = t_remote - offset."""
    rank, size = comm.rank, comm.size
    out = [(0.0, 0.0)] * size
    buf = np.zeros(1, dtype=np.float64)
    for peer in range(1, size):
        comm.Barrier()
        if rank == 0:
            best_rtt, best_off = float("inf"), 0.0
            for _ in range(rounds):
                t1 = time.time()
                comm.Send(buf, peer, tag=1)
                r = np.empty(1, dtype=np.float64)
                comm.Recv(r, peer, tag=2)
                t4 = time.time()
                rtt = t4 - t1
                if rtt < best_rtt:
                    # remote stamped r[0] at its midpoint; offset at
                    # min RTT assumes symmetric paths (NTP estimator)
                    best_rtt = rtt
                    best_off = float(r[0]) - (t1 + t4) / 2.0
            out[peer] = (best_off, best_rtt)
        elif rank == peer:
            for _ in range(rounds):
                r = np.empty(1, dtype=np.float64)
                comm.Recv(r, 0, tag=1)
                buf[0] = time.time()
                comm.Send(buf, 0, tag=2)
    # everyone learns the table (rank 0 may not be the only consumer)
    table = np.array([[o, r] for o, r in out], dtype=np.float64)
    comm.Bcast(table, root=0)
    return [(float(o), float(r)) for o, r in table]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mpisync")
    ap.add_argument("--rounds", type=int, default=50)
    opts = ap.parse_args(argv)

    import ompi_tpu_torch
    comm = ompi_tpu_torch.init()
    offsets = measure_offsets(comm, rounds=opts.rounds)
    if comm.rank == 0:
        for r, (off, rtt) in enumerate(offsets):
            sys.stdout.write(
                f"rank {r}: offset {off * 1e6:+.1f} us  "
                f"rtt {rtt * 1e6:.1f} us\n")
        sys.stdout.write(json.dumps(
            {"offsets_us": [round(o * 1e6, 2) for o, _ in offsets],
             "rtts_us": [round(t * 1e6, 2) for _, t in offsets]})
            + "\n")
        sys.stdout.flush()
    ompi_tpu_torch.finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
