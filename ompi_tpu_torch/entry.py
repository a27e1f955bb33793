"""Driver entry points of the port (the reference's
__graft_entry__.py).

entry()             — the single-card collective step: 8 ranks
                      co-located on one card, their buffers stacked
                      (8, N) → allreduce(SUM) + reduce_scatter +
                      alltoall, in ONE launch of K12 driver_step
                      (kernels/entry.py).
dryrun_multichip(n) — n rank threads on n logical devices of one card
                      (the mesh tier, coll/tpu): the multi-axis step of
                      the reference's _dryrun_body on a (dp, sp)
                      cartesian grid — allreduce, reduce_scatter,
                      alltoall and allgather on the dp sub-communicator
                      (K6 mesh_fold and K2 peer), the ring shift over sp
                      (``shift_arr``) — then the MPI part on the world
                      communicator.

Both run on the card (cuda:0) unless the caller passes
``device="cpu"``, where the kernels' plain versions run; with no card
and no ``device="cpu"`` they raise.  The elementwise ``x * w`` and the
closing ``.sum()`` calls of the step stay torch ops: they are each
rank's local arithmetic around the collectives.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch

NRANKS = 8


def _device(device) -> torch.device:
    """The card (cuda:0), or the device the caller names; never a
    silent fallback to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card is available; pass device='cpu' "
                           "to run on the CPU")
    return torch.device("cuda", 0)


def entry(device=None) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): the single-card collective step.  fn(x) on
    x of shape (8, N), N % 8 == 0, returns (allred + a2a, rs), one K12
    launch on a card."""
    from ompi_tpu_torch.kernels.entry import driver_step
    x = torch.ones((NRANKS, 1024), dtype=torch.float32,
                   device=_device(device))
    return driver_step, (x,)


def _grid(n: int) -> Tuple[int, int]:
    """(dp, sp): a 2-D grid when n is even and over 2, else (n, 1) —
    the reference's choice (__graft_entry__.py:99-102)."""
    return (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)


def _step(cart, dpc, spc, x, w):
    """The reference's ``step`` (__graft_entry__.py:106-119) on this
    rank's shard x of shape (dp, cols): dp collectives on the dp
    sub-communicator, the sp ring on the sp one."""
    from ompi_tpu_torch.op.op import SUM
    g = dpc.allreduce_arr(x * w, SUM)      # psum over dp
    rs = dpc.reduce_scatter_arr(g, SUM)    # psum_scatter over dp, tiled
    nbr = spc.shift_arr(rs, 0, 1)          # ring ppermute over sp
    a2a = dpc.alltoall_arr(x)              # all_to_all over dp, tiled
    ag = dpc.allgather_arr(nbr)            # all_gather over dp, tiled
    return (a2a + ag).sum() + rs.sum()


def _mpi_step(comm):
    """The MPI part of the dry run (__graft_entry__.py:141-156) on the
    world communicator."""
    from ompi_tpu_torch.op.op import SUM
    x = torch.full((comm.size * 2,), comm.rank + 1.0, dtype=torch.float32,
                   device=comm.device)
    r = comm.allreduce_arr(x, SUM)
    rs = comm.reduce_scatter_arr(x, SUM)
    a2a = comm.alltoall_arr(x)
    ring = comm.ppermute_arr(
        x, [(i, (i + 1) % comm.size) for i in range(comm.size)])
    sub = comm.split(comm.rank % 2)
    sr = sub.allreduce_arr(x, SUM)
    if float(r[0]) != sum(range(1, comm.size + 1)):
        raise AssertionError(f"allreduce gave {float(r[0])}")
    return float(sr[0]) + float(rs[0]) + float(a2a[0]) + float(ring[0])


def _dryrun_body(n: int, cols: int = 8, device=None) -> List[tuple]:
    """n rank threads on n logical devices of ``device``; each runs the
    step on a Create_cart([dp, sp], periods=[True, True]) grid at shard
    width ``cols`` (the reference's is 8), then the MPI part.  Returns
    each rank's (step value, MPI value), rank order."""
    from ompi_tpu_torch.testing import logical_devices, run_ranks
    dev = _device(device)
    dp, sp = _grid(n)

    def fn(comm):
        cart = comm.Create_cart([dp, sp], periods=[True, True])
        dpc = cart.Sub([True, False])
        spc = cart.Sub([False, True])
        # rank r's shard of arange(rows * cols).reshape(rows, cols),
        # rows = dp * sp * dp, sharded over (dp, sp): dp rows a rank
        lo = cart.rank * dp * cols
        x = torch.arange(lo, lo + dp * cols, dtype=torch.float32,
                         device=comm.device).reshape(dp, cols)
        w = torch.ones_like(x)
        step = float(_step(cart, dpc, spc, x, w))
        return step, _mpi_step(comm)

    return run_ranks(n, fn, device_map=logical_devices(dev), timeout=300)


def dryrun_multichip(n: int, device=None) -> List[tuple]:
    """The multi-axis step and the MPI part on n logical devices of the
    card (or of ``device``); returns each rank's (step, MPI) values."""
    return _dryrun_body(n, device=device)
