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

The process-rank half (the KV note watcher, ``runtime/ft.py``'s live
recovery) waits for the launcher RTEs (ROADMAP.md A8).
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
