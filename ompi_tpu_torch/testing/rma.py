"""The promoted one-sided RMA workloads, for the tests and the card's
smoke run: the rma_counter and halo_stencil examples as the reference's
device-window tests drive them (a fence put ring, a passive atomic
counter by fetch_and_op, a compare_and_swap election; each rank puts
its tile edges into its neighbours' windows).

Each takes the osc and op modules to run against (this package's, or
another implementation of the same API) and a ``Buffers`` that makes
its origin and result buffers: numpy arrays, or tensors on the rank's
device.  Each returns a rank function for ``run_ranks`` whose result
is a dict of raw bytes, so two runs compare byte for byte.
"""

from __future__ import annotations

import numpy as np
import torch


class Buffers:
    """Origin and result buffers of a workload: numpy arrays, or
    (``tensors``) tensors on the rank's device."""

    def __init__(self, tensors: bool = False) -> None:
        self.tensors = tensors

    def origin(self, comm, a) -> object:
        a = np.ascontiguousarray(a)
        if not self.tensors:
            return a
        return torch.from_numpy(a).to(comm.device)

    def result(self, comm, n: int, dtype) -> object:
        if not self.tensors:
            return np.empty(n, dtype=dtype)
        return torch.from_numpy(np.zeros(n, dtype=dtype)).to(comm.device)


def host(x) -> np.ndarray:
    """A numpy copy of an array or tensor (a card tensor is copied to
    the host here, by the workload, for the comparison)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.array(x)


def counter_workload(osc, ops, bufs: Buffers = Buffers()):
    """examples/rma_counter.py: fence put ring, passive atomic
    counter, fetch_and_op ticketing, compare_and_swap."""
    def fn(comm):
        rank, size = comm.rank, comm.size
        out = {}

        ring = osc.allocate(comm, 16, disp_unit=8, name="ring")
        out["component"] = type(ring).__name__
        ring.fence()
        ring.put(bufs.origin(comm, np.full(2, rank, dtype=np.int64)),
                 (rank + 1) % size)
        ring.fence()
        out["ring"] = host(ring.memory).tobytes()

        # passive target: int64 counter on rank 0
        ctr = osc.allocate(comm, 8, disp_unit=8, name="ctr")
        tickets = []
        for _ in range(5):
            old = bufs.result(comm, 1, np.int64)
            ctr.lock(0, osc.LOCK_SHARED)
            ctr.fetch_and_op(1, old, 0, op=ops.SUM)
            ctr.unlock(0)
            tickets.append(int(host(old)[0]))
        if sorted(set(tickets)) != tickets:
            raise AssertionError(f"tickets not monotone: {tickets}")
        comm.Barrier()
        got = bufs.result(comm, 1, np.int64)
        ctr.lock(0, osc.LOCK_SHARED)
        ctr.get(got, 0)
        ctr.unlock(0)
        if int(host(got)[0]) != 5 * size:
            raise AssertionError(f"counter {host(got)} != {5 * size}")
        out["counter"] = host(got).tobytes()

        # compare_and_swap election on an int32 slot
        slot = osc.allocate(comm, 4, disp_unit=4, name="cas")
        oldv = bufs.result(comm, 1, np.int32)
        slot.lock(0, osc.LOCK_SHARED)
        slot.compare_and_swap(np.int32(0), np.int32(rank + 1), oldv, 0)
        slot.unlock(0)
        comm.Barrier()
        winner = bufs.result(comm, 1, np.int32)
        slot.lock(0, osc.LOCK_SHARED)
        slot.get(winner, 0)
        slot.unlock(0)
        w = int(host(winner)[0])
        if not 1 <= w <= size:
            raise AssertionError(f"CAS winner {w}")
        out["cas_winner_is_set"] = w != 0

        slot.free()
        ctr.free()
        ring.free()
        return out
    return fn


HALO_N = 32


def halo_workload(osc, bufs: Buffers = Buffers()):
    """examples/halo_stencil.py, RMA-flavored: each rank PUTS its
    tile edges into the neighbours' windows (west slot / east slot)."""
    def fn(comm):
        rank, size = comm.rank, comm.size
        n = HALO_N
        win = osc.allocate(comm, 2 * n * 4, disp_unit=4, name="halo")
        tile = (np.arange(n, dtype=np.float32) + 1) * (rank + 1)
        win.fence()
        win.put(bufs.origin(comm, tile), (rank + 1) % size, disp=0)
        win.put(bufs.origin(comm, tile * 2), (rank - 1) % size, disp=n)
        win.fence()
        halo = host(win.memory).tobytes()
        # one relaxation step off the received halos
        mem = np.frombuffer(halo, dtype=np.float32)
        west, east = mem[:n], mem[n:]
        new = (tile + west + east) / 3.0
        win.free()
        return {"component": type(win).__name__, "halo": halo,
                "tile": new.tobytes()}
    return fn


def expected_halo(rank: int, size: int) -> bytes:
    n = HALO_N
    base = np.arange(n, dtype=np.float32) + 1
    west = base * ((rank - 1) % size + 1)
    east = base * 2 * ((rank + 1) % size + 1)
    return np.concatenate([west, east]).tobytes()
