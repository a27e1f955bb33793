"""The flat MPI_* surface on a card (gpu-marked: skips where no card is
present).  No JAX here, so the file runs on a machine without it:
``python -m pytest tests/test_torch_flat_card.py -m gpu``.

chip_smoke.py's phase 18 as pytest cases, through
ompi_tpu_torch.testing.flat's rank programs, 8 rank-threads on the
card (coll/hbm).  18a: the world from MPI_COMM_WORLD(), a copying
attribute, MPI_Comm_dup, MPI_ERRORS_RETURN, pml/monitoring on; 20
allreduce_arr of 8 MiB float32 on the duplicate launch K1 exactly 20
times, and the MPI_T deltas are the plan tier's 8 builds and 152 hits
and monitoring's 20 deposits of 8 MiB to each other rank; host
MPI_Allreduce and PMPI_Allreduce through coll/sm equal numpy.  18b:
with the memchecker on, a card tensor's send_arr keeps its digest, a
changed MPI_Isend buffer raises, a posted MPI_Irecv reads 0xCB.  18c:
a user errhandler is called once a rank by an MPI_Bcast with its root
out of range; the next allreduce_arr launches K1 once; MPI_Comm_free
runs the delete function.

Tolerance: the float SUM band, |y - sum x| <= N 2**-24 sum |x|, for
the card sums; bytes for everything else.
"""

import pytest
import torch

from ompi_tpu_torch import errhandler
from ompi_tpu_torch.kernels import stacked
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.testing import flat, run_ranks

N = 8
ELEMS = 2 << 20            # 8 MiB of float32 a rank
OPS = 20
HOST = (8, 8 << 20)


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (K1 launches there; the CPU runs "
                    "its plain version)")
    return torch.device("cuda", 0)


def _knob(name, value):
    saved = registry.get(name)
    registry.set(name, value)
    return lambda: registry.set(name, saved)


def _k1(fn, n, dev):
    k1 = stacked.stacked_reduce.launches
    k1.reset()
    out = run_ranks(n, fn, device_map=lambda r: dev)
    torch.cuda.synchronize()
    return out, k1.value


def _in_band(y, dev):
    xs = [flat.values(r, ELEMS, dev).double() for r in range(N)]
    err = (y.double() - sum(xs)).abs()
    return bool((err <= N * 2.0 ** -24 * sum(x.abs() for x in xs)).all())


@pytest.mark.gpu
def test_headline_through_mpi_handles(cuda_device):
    restore = _knob("pml_monitoring_enable", True)
    try:
        res, k1 = _k1(flat.headline(cuda_device, ELEMS, OPS, HOST), N,
                      cuda_device)
    finally:
        restore()
    assert k1 == OPS
    for r, out in enumerate(res):
        other = [0 if p == r else 1 for p in range(N)]
        assert out["copies"] == [r] and out["attr"] == (True, r + 1)
        assert out["errhandler"]
        assert out["pvars"] == {
            "pml_monitoring_filtered_count": [OPS * o for o in other],
            "pml_monitoring_filtered_size": [OPS * 4 * ELEMS * o
                                             for o in other],
            "coll_plan_builds": N, "coll_plan_hits": N * (OPS - 1)}
        assert out["y"].device.type == "cuda" and _in_band(out["y"],
                                                           cuda_device)
        assert out["host_provider"] == "sm"
        for (a, b), nb in zip(out["host"], HOST):
            assert a == b == flat.host_sum(N, nb)


@pytest.mark.gpu
def test_memchecker_on_the_card(cuda_device):
    restore = _knob("opal_memchecker_enable", True)
    try:
        res, k1 = _k1(flat.memcheck(cuda_device, ELEMS, 8 << 20), 2,
                      cuda_device)
    finally:
        restore()
    (err, sent), (kind, got, posted, done) = res
    assert (kind, got) == ("cuda", sent)
    assert sent == flat.digest(flat.values(0, ELEMS, cuda_device))
    assert err.startswith("memchecker: send buffer of rendezvous send req ")
    assert (posted, done) == (b"\xcb", b"\x00")
    assert k1 == 0


@pytest.mark.gpu
def test_errhandler_then_headline(cuda_device):
    res, k1 = _k1(flat.errhandlers(cuda_device, ELEMS), N, cuda_device)
    assert k1 == 1
    for r, (calls, raised, y, deleted) in enumerate(res):
        assert calls == [(True, errhandler.ERR_OTHER)]
        assert raised is not None and deleted == [100 + r]
        assert _in_band(y, cuda_device)
