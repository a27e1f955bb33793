"""coll/sm and the intercomm's merged communicator on a card (gpu-
marked: skips where no card is present).  No JAX here, so the file runs
on a machine without it:
``python -m pytest tests/test_torch_inter_card.py -m gpu``.

8 rank-threads on the card (coll/hbm).  The interleave: steps of
``allreduce_arr`` (K1), a host Allreduce of one float64 and a host
Bcast of 64 int64 through coll/sm, ``allgather_arr`` (K2) and a
Barrier on one communicator — one rendezvous, host deposits between
the card meetings: K1 and K2 once a step each, sm launches nothing,
every card result plain torch's and every host result numpy's.  The
merged communicator of an intercomm over two groups of 4: its
``allreduce_arr`` is one K1 launch an op.  Tolerance: small-integer
float32 inputs, so the SUM is exact (bytes).
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch.kernels import stacked
from ompi_tpu_torch.op.op import SUM
from ompi_tpu_torch.testing import run_ranks

SEED = 20261018
N = 8


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 and K2 launch there; the "
                    "CPU runs their plain versions)")
    return torch.device("cuda", 0)


def _values(rank, n, dev, salt):
    g = np.random.default_rng(SEED + salt * 100 + rank)
    return torch.as_tensor(g.integers(0, 1000, n).astype(np.float32),
                           device=dev)


def _counted(run):
    """(results, K1 launches, K2 launches) of ``run()``."""
    k1, k2 = stacked.stacked_reduce.launches, stacked.stacked_copy.launches
    k1.reset()
    k2.reset()
    out = run()
    torch.cuda.synchronize()
    return out, k1.value, k2.value


@pytest.mark.gpu
def test_sm_meetings_between_card_meetings(cuda_device):
    n, steps = 1 << 20, 5

    def fn(comm):
        x = _values(comm.rank, n, cuda_device, 1)
        outs = []
        for s in range(steps):
            y = comm.allreduce_arr(x, SUM)
            g = np.random.default_rng(SEED + 97 * s + comm.rank)
            tot = np.empty(1)
            comm.Allreduce(np.array([g.standard_normal()]), tot, SUM)
            b = g.integers(0, 1 << 40, 64) if comm.rank == 0 \
                else np.zeros(64, np.int64)
            comm.Bcast(b, root=0)
            z = comm.allgather_arr(x[:4096])
            comm.Barrier()
            outs.append((y.cpu().numpy(), tot, b, z.cpu().numpy()))
        return comm.coll.providers["allreduce"], outs

    res, k1, k2 = _counted(lambda: run_ranks(
        N, fn, device_map=lambda r: cuda_device))
    assert (k1, k2) == (steps, steps)
    xs = [_values(r, n, "cpu", 1).numpy() for r in range(N)]
    want_y = np.sum(xs, axis=0, dtype=np.float32)
    want_z = np.concatenate([x[:4096] for x in xs])
    for prov, outs in res:
        assert prov == "sm"
        for s, (y, tot, b, z) in enumerate(outs):
            gs = [np.random.default_rng(SEED + 97 * s + r)
                  for r in range(N)]
            acc = np.array([gs[0].standard_normal()])
            for g in gs[1:]:
                acc = acc + g.standard_normal()
            assert y.tobytes() == want_y.tobytes()
            assert z.tobytes() == want_z.tobytes()
            assert tot.tobytes() == acc.tobytes()
            assert b.tobytes() == gs[0].integers(0, 1 << 40, 64).tobytes()


@pytest.mark.gpu
def test_merged_intercomm_allreduce_arr_is_one_k1(cuda_device):
    n, ops = 1 << 20, 3

    def fn(comm):
        low = comm.rank < N // 2
        local = comm.split(0 if low else 1)
        inter = local.create_intercomm(0, comm, N // 2 if low else 0)
        merged = inter.merge(high=not low)
        x = _values(merged.rank, n, cuda_device, 2)
        ys = [merged.allreduce_arr(x, SUM) for _ in range(ops)]
        return merged.coll.providers["allreduce_arr"], \
            [y.cpu().numpy() for y in ys]

    res, k1, k2 = _counted(lambda: run_ranks(
        N, fn, device_map=lambda r: cuda_device))
    assert (k1, k2) == (ops, 0)
    want = np.sum([_values(r, n, "cpu", 2).numpy() for r in range(N)],
                  axis=0, dtype=np.float32)
    for prov, ys in res:
        assert prov == "hbm"
        assert all(y.tobytes() == want.tobytes() for y in ys)
