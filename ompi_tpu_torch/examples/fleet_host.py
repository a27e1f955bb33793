"""Host-kill workload of the resident pool's fleet (tools/dvm.py
``--hosts N``): a deterministic stepped allreduce on a session whose
last host domain dies mid-loop.  The port's copy of the reference's
``tests/_fleet_host_prog.py``: the same steps, lines and digest.

Every rank resident on the dead host is published as failed in ONE
domain record, so the ULFM survivors observe a single consistent
failure set: each survivor shrinks exactly once, resets, and redoes the
whole accumulation on the shrunk world — every survivor's digest is
byte-identical whichever step the kill interrupted.  Ranks on the dead
host exit 0 the moment they see themselves dead (a killed host's ranks
do not finalize; in the pool a rank-thread stands in for the vanished
process).

    python -m ompi_tpu_torch.tools.mpirun --dvm /tmp/dvm.uri -np 4 \\
        ompi_tpu_torch/examples/fleet_host.py TAG STEPS \\
        [KILL_RANK:KILL_STEP] [--hold STEP PATH] [--device auto|cpu] \\
        [--mib N]

``KILL_RANK:KILL_STEP`` makes world rank KILL_RANK call
``ulfm.kill_now`` at the top of step KILL_STEP of its first pass (a
step-boundary rank death).  ``--hold STEP PATH`` is the deterministic
kill point of a host kill: at step STEP of the first pass rank 0 writes
PATH and every rank then waits in a receive from a rank of the last
host domain that nobody sends — whoever watches PATH kills that host,
and the wait ends in ERR_PROC_FAILED (the survivors shrink) or in the
rank's own death.

Every survivor prints ``SHRINKS {tag} {rank} {n}`` and ``DIGEST {tag}
{sha256}`` (the reference's lines), then reduces a tensor of ``--mib``
MiB of float32 (8 by default) on its device with ``allreduce_arr`` over
the survivors' communicator (one K1 launch on a card: the pool's ranks
share it, the coll/hbm tier) and prints ``CARD {tag} {rank} {sha256}``
of the result.  ``--device`` names the device the pool is expected to
have given the ranks (``auto``: a card); a mismatch exits non-zero.
"""
import hashlib
import os
import sys
import time

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch.errhandler import MPIException
from ompi_tpu_torch.op import op as mpi_op


argv = list(sys.argv[1:])


def _opt(name, n, default):
    if name not in argv:
        return default
    i = argv.index(name)
    vals = argv[i + 1:i + 1 + n]
    del argv[i:i + 1 + n]
    return vals if n > 1 else vals[0]


hold = _opt("--hold", 2, None)
choice = _opt("--device", 1, "auto")
mib = int(_opt("--mib", 1, "8"))
tag = argv[0]
steps = int(argv[1])
kill_rank, kill_step = (-1, -1)
if len(argv) > 2:
    kill_rank, kill_step = (int(x) for x in argv[2].split(":"))
hold_step = int(hold[0]) if hold else -1

comm = ompi_tpu_torch.init(device=choice)
me = comm.rank
size = comm.size
work = comm
vec = np.zeros(32, np.float64)
shrinks = 0
step = 0


def _i_am_dead():
    # a rank never ingests its OWN failure into ulfm.failed; the
    # host-kill path marks the victim incarnations with the same
    # ulfm_dead flag ft_inject rank_kill uses
    return getattr(comm.state, "ulfm_dead", False)


def _hold():
    """Rank 0 writes the hold file; every rank waits on a receive from
    a rank of the last host domain (not itself) that nobody sends."""
    if me == 0:
        tmp = hold[1] + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(f"{tag} {step}\n")
        os.replace(tmp, hold[1])
    peer = size - 1 if me != size - 1 else size - 2
    comm.Recv(np.empty(1, np.float64), source=peer, tag=7007)


while step < steps:
    if _i_am_dead():
        # my host is the one that died: vanish without finalize.
        # Checked BEFORE each op — a dead rank must never meet
        # survivors that already shrank around it
        sys.exit(0)
    if me == kill_rank and step == kill_step and shrinks == 0:
        from ompi_tpu_torch.ft import ulfm as _ulfm
        _ulfm.kill_now(comm.state)
    contrib = np.full(32, float((step + 1) * (work.rank + 1)),
                      np.float64)
    r = np.empty_like(contrib)
    try:
        if step == hold_step and shrinks == 0:
            _hold()
        work.Allreduce(contrib, r, mpi_op.SUM)
    except MPIException as e:
        assert e.code in (75, 76, 77), e.code
        if _i_am_dead():
            sys.exit(0)
        # survivors: one shrink, then redo the run from step 0 on the
        # shrunk world — survivors may disagree on whether the
        # interrupted step completed, so partial sums are discarded
        # rather than reconciled
        work = work.shrink(name="survivors")
        shrinks += 1
        vec = np.zeros(32, np.float64)
        step = 0
        continue
    except Exception:  # noqa: BLE001
        # backstop for the publish/op race: a dead rank that slipped
        # into one more op against a world the survivors are already
        # reshaping dies HERE, not as a job failure
        if _i_am_dead():
            sys.exit(0)
        raise
    vec = vec + r
    step += 1
    time.sleep(0.02)

dig = hashlib.sha256(vec.tobytes()).hexdigest()
# the card tensor: every survivor's rank + 1 in each of mib MiB of
# float32, summed over the survivors — exact in float32
dev = comm.device
x = torch.full((mib * (1 << 20) // 4,), float(work.rank + 1),
               dtype=torch.float32, device=dev)
card = work.allreduce_arr(x, mpi_op.SUM)
cdig = hashlib.sha256(card.cpu().numpy().tobytes()).hexdigest()
# one write a line: rank-threads share the session's stdout
sys.stdout.write(f"SHRINKS {tag} {me} {shrinks}\n")
sys.stdout.write(f"DIGEST {tag} {dig}\n")
sys.stdout.write(f"CARD {tag} {me} {cdig}\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
