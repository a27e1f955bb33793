"""Fault tolerance on a card (gpu-marked: skips where no card is
present).  No JAX here, so the file runs on a machine without it:
``python -m pytest tests/test_torch_ft_card.py -m gpu``.

chip_smoke.py's phase 10 at a small size (64 KiB a rank), through the
kernels: 10a and 10b — rank 3 of 8 dies, the survivors shrink and the
last step's bytes equal a fresh 7-rank world's, on coll/hbm (K1) and on
8 logical devices of the card (K6 + K2 peer); 10c — rank 1 dies after
its buddy checkpoint, its replacement rejoins and restores its card
tensor from its partner, and every rank's bytes equal the fault-free
run's; 10d — the counter workload on the survivors equals a fresh
world's (K9, K10).  Tolerance: bytes (each pair runs the same kernels
over the same inputs in the same order).
"""

import pytest
import torch

from ompi_tpu_torch import errhandler as eh
from ompi_tpu_torch import osc
from ompi_tpu_torch.cr import buddy
from ompi_tpu_torch.ft import respawn, ulfm
from ompi_tpu_torch.kernels import mesh, rma, stacked
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks
from ompi_tpu_torch.testing.rma import Buffers, counter_workload

SEED = 20261018
N_ELEMS = 1 << 14
STEPS, KILL = 6, 3
FT = (eh.ERR_PROC_FAILED, eh.ERR_PROC_FAILED_PENDING, eh.ERR_REVOKED)


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs, never
    when the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU build)")
    return torch.device("cuda", 0)


def _x(rank, step, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 100 * step + rank)
    return torch.randn(N_ELEMS, generator=g, device=dev)


def _same(a, b):
    return torch.equal(a.view(torch.uint8), b.view(torch.uint8))


def _counts():
    return (stacked.stacked_reduce.launches.value,
            mesh.mesh_fold.launches.value, stacked.peer_copy.launches.value)


def _shrink_run(n, dm, kill):
    def fn(comm):
        work, out, step = comm, None, 0
        while step < STEPS:
            if kill and work is comm and comm.rank == 3 and step == KILL:
                ulfm.kill_now(comm.state)
            try:
                out = work.allreduce_arr(_x(work.rank, step,
                                            comm.state.device), port_op.SUM)
                step += 1
            except eh.MPIException as e:
                assert e.code in FT
                work = work.shrink()
        torch.cuda.synchronize()
        return out, work.size
    return run_ranks(n, fn, device_map=dm, allow_failures=kill)


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_shrink_on_card(cuda_device, tier):
    dm = (lambda r: cuda_device) if tier == "hbm" else \
        logical_devices(cuda_device)
    c0 = _counts()
    got = _shrink_run(8, dm, True)
    c1 = _counts()
    fresh = _shrink_run(7, dm, False)
    c2 = _counts()
    assert got[3] is None
    live = [g for g in got if g is not None]
    assert all(size == 7 for _, size in live)
    for (out, _), (ref, _) in zip(live, fresh):
        assert _same(out, ref)
    run = [b - a for a, b in zip(c0, c1)]
    fresh_l = [b - a for a, b in zip(c1, c2)]
    # KILL ops on 8 ranks and STEPS - KILL on 7, the same kernels a
    # step: as many launches as a fault-free run of STEPS ops
    assert run == fresh_l and sum(run) > 0, (run, fresh_l)


def _respawn_fn(victims):
    def fn(comm):
        dev = comm.state.device
        joining = respawn.joining(comm.state)
        if joining:
            comm = respawn.rejoin(comm)
            st = buddy.restore(comm)
            i, acc = int(st["i"]), st["acc"]
            assert acc.device == dev
        else:
            i, acc = 0, torch.zeros(N_ELEMS, device=dev)
        killed = False
        while i < STEPS:
            try:
                buddy.checkpoint(comm, {"i": i, "acc": acc})
                if not joining and not killed and victims.get(comm.rank) == i:
                    killed = True
                    ulfm.kill_now(comm.state)
                acc = acc + comm.allreduce_arr(_x(comm.rank, i, dev),
                                               port_op.SUM)
                i += 1
            except eh.MPIException as e:
                assert e.code in FT
                comm = respawn.rejoin(comm)
                st = buddy.restore(comm)
                i, acc = int(st["i"]), st["acc"]
        torch.cuda.synchronize()
        return acc
    return fn


@pytest.mark.gpu
def test_respawn_restores_card_state(cuda_device):
    saved = registry.get("cr_buddy_degree")
    registry.set("cr_buddy_degree", 1)
    try:
        clean = run_ranks(8, _respawn_fn({}),
                          device_map=lambda r: cuda_device)
        faulty = run_ranks(8, _respawn_fn({1: KILL}),
                           device_map=lambda r: cuda_device, respawn=True)
    finally:
        registry.set("cr_buddy_degree", saved)
    for a, b in zip(faulty, clean):
        assert _same(a, b)


@pytest.mark.gpu
def test_window_across_shrink_on_card(cuda_device):
    wl = counter_workload(osc, port_op, Buffers(True))

    def chaos(comm):
        comm.agree(True)
        if comm.rank == 3:
            ulfm.kill_now(comm.state)
        work = comm
        while work is comm:
            try:
                work.Barrier()
            except eh.MPIException as e:
                assert e.code in FT
                work = work.shrink()
        return wl(work)

    dm = logical_devices(cuda_device)
    k0 = (rma.rma_acc.launches.value, rma.rma_cas.launches.value)
    got = run_ranks(8, chaos, device_map=dm, allow_failures=True)
    k1 = (rma.rma_acc.launches.value, rma.rma_cas.launches.value)
    fresh = run_ranks(7, wl, device_map=dm)
    assert got[3] is None
    assert [g for g in got if g is not None] == fresh
    assert (k1[0] - k0[0], k1[1] - k0[1]) == (5 * 7, 7)
