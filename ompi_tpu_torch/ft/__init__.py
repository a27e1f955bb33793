"""User-level failure mitigation (ULFM / MPI-4 FT proposal analog).

Port of the reference's ft package, thread-rank worlds: permanent
rank death is detected, surfaced to the application as
``MPI_ERR_PROC_FAILED``, and mitigated in place with
``Comm.revoke()`` / ``Comm.agree()`` / ``Comm.shrink()`` so the job
continues on the survivors (ref: ompi/communicator/ft and the
MPIX_Comm_* surface of the ULFM prototype).

``ft/respawn.py`` adds the third tier: instead of shrinking around a
dead rank, the thread-world harness (``testing.run_ranks``) starts a
replacement that takes
the same world rank, restores its state from a buddy checkpoint
(``cr/buddy.py``) and rejoins at full size.

Process ranks under mpirun's ulfm and respawn policies consume the
failure and revoke notes through ULFM's KV note watcher
(``ulfm.start_watcher``); the recover policy's live recovery, which
re-routes a dead node's ranks and rolls every rank back to a snapshot,
is ``runtime/ft.py``.
"""

from ompi_tpu_torch.ft.ulfm import (  # noqa: F401
    RankKilled,
    UlfmState,
    agree,
    arm_rank_kill,
    attach,
    kill_now,
    publish_failure,
    publish_revoke,
    publish_world_failure,
    purge_store,
    purge_tickets,
    shrink,
)
from ompi_tpu_torch.ft import respawn  # noqa: F401
