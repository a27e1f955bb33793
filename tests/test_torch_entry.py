"""The driver's entry points through both packages:
``ompi_tpu_torch.entry`` against the reference's ``__graft_entry__``.

B15, the single-card step: the port's ``entry()`` fn (K12
``driver_step``, its plain version on the CPU) against the reference's
``collective_step`` jitted on the CPU, on the same seeded numpy input.
Integer-valued float32 and int32 are exact; normal float32 is within
|port - ref| <= 8 * 2**-23 * sum_r |x[r, c]| a column (the two sum the
rows in other orders).

B16, the multichip step: ``dryrun_multichip(n, device="cpu")`` runs n
rank threads on n logical CPU devices.  Each rank's step value is held
exactly against a numpy statement of ``step``
(__graft_entry__.py:106-119) on the same arange inputs; each rank's
MPI value against the same rank program (:141-156) run through
``ompi_tpu`` on the conftest's virtual CPU devices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import entry as port_entry
from ompi_tpu_torch.kernels.entry import driver_step_plain

SHAPES = [(8, 1024), (8, 4096)]


def _ref_step(x: np.ndarray):
    fn, _ = ref_entry.entry()
    out, rs = jax.jit(fn)(jnp.asarray(x))
    return np.asarray(out), np.asarray(rs)


def _port_step(x: np.ndarray):
    fn, (ex,) = port_entry.entry(device="cpu")
    assert ex.shape == (8, 1024) and ex.dtype == torch.float32
    out, rs = fn(torch.from_numpy(x))
    return out.numpy(), rs.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("kind", ["int_valued_f32", "int32"])
def test_entry_exact_against_reference(shape, kind):
    rng = np.random.default_rng(shape[1] + len(kind))
    x = rng.integers(-1000, 1000, shape)
    x = x.astype(np.float32 if kind == "int_valued_f32" else np.int32)
    p_out, p_rs = _port_step(x)
    r_out, r_rs = _ref_step(x)
    assert p_out.dtype == r_out.dtype and p_rs.dtype == r_rs.dtype
    assert p_out.tobytes() == r_out.tobytes()
    assert p_rs.tobytes() == r_rs.tobytes()


@pytest.mark.parametrize("shape", SHAPES)
def test_entry_float32_within_band(shape):
    rng = np.random.default_rng(shape[1])
    x = rng.standard_normal(shape).astype(np.float32)
    p_out, p_rs = _port_step(x)
    r_out, r_rs = _ref_step(x)
    col = 8 * 2.0 ** -23 * np.abs(x.astype(np.float64)).sum(0)
    assert (np.abs(p_out.astype(np.float64) - r_out) <= col[None, :]).all()
    n = shape[1] // 8
    assert (np.abs(p_rs.astype(np.float64) - r_rs)
            <= col.reshape(8, n)).all()


def test_entry_plain_is_the_fn_on_cpu():
    """On the CPU the entry fn is K12's wrapper, which takes the plain
    version: the same bytes as driver_step_plain."""
    fn, (x,) = port_entry.entry(device="cpu")
    x = x * torch.arange(1024, dtype=torch.float32)
    out, rs = fn(x)
    w_out, w_rs = driver_step_plain(x)
    assert torch.equal(out, w_out) and torch.equal(rs, w_rs)
    assert torch.equal(out[3, :5], torch.tensor([
        8 * 0.0 + 384, 8 * 1.0 + 385, 8 * 2.0 + 386, 8 * 3.0 + 387,
        8 * 4.0 + 388]))


def test_entry_takes_the_card_unless_asked():
    """No card and no device='cpu': both entry points raise (never a
    silent CPU run); with a card, entry() lands on it."""
    if torch.cuda.is_available():
        _, (x,) = port_entry.entry()
        assert x.is_cuda
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_entry.dryrun_multichip(4)


# -- B16 ---------------------------------------------------------------------

def _np_step(n: int, cols: int = 8):
    """Each rank's value of the reference's ``step`` in numpy (float64:
    every value is an integer well inside float32's exact range)."""
    dp, sp = (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)
    rows = dp * sp * dp
    gx = np.arange(rows * cols, dtype=np.float64).reshape(rows, cols)
    shard = [gx[r * dp:(r + 1) * dp] for r in range(n)]
    rank = lambda i, j: i * sp + j  # noqa: E731 (grid position -> rank)
    out = []
    for r in range(n):
        i, j = divmod(r, sp)
        g = {jj: sum(shard[rank(ii, jj)] for ii in range(dp))
             for jj in range(sp)}
        rs = {(ii, jj): dp * g[jj][ii:ii + 1]
              for ii in range(dp) for jj in range(sp)}
        a2a = np.concatenate([shard[rank(ii, j)][i:i + 1]
                              for ii in range(dp)])
        ag = np.concatenate([rs[(ii, (j - 1) % sp)] for ii in range(dp)])
        out.append(a2a.sum() + ag.sum() + rs[(i, j)].sum())
    return out


def _ref_mpi_step(comm):
    x = jax.device_put(
        jnp.full((comm.size * 2,), comm.rank + 1.0, jnp.float32),
        comm.device)
    r = comm.allreduce_arr(x, ref_op.SUM)
    rs = comm.reduce_scatter_arr(x, ref_op.SUM)
    a2a = comm.alltoall_arr(x)
    ring = comm.ppermute_arr(
        x, [(i, (i + 1) % comm.size) for i in range(comm.size)])
    sub = comm.split(comm.rank % 2)
    sr = sub.allreduce_arr(x, ref_op.SUM)
    assert float(np.asarray(r)[0]) == sum(range(1, comm.size + 1))
    return float(np.asarray(sr)[0]) + float(np.asarray(rs)[0]) + \
        float(np.asarray(a2a)[0]) + float(np.asarray(ring)[0])


@pytest.mark.parametrize("n", [8, 6, 3])
def test_dryrun_step_exact_against_numpy(n):
    res = port_entry.dryrun_multichip(n, device="cpu")
    assert [s for s, _ in res] == _np_step(n)


@pytest.mark.parametrize("n", [8, 6, 3])
def test_dryrun_mpi_part_against_reference(n):
    res = port_entry.dryrun_multichip(n, device="cpu")
    ref = ref_run_ranks(n, _ref_mpi_step, devices=True, timeout=300)
    assert [m for _, m in res] == ref


def test_dryrun_body_takes_the_shard_width():
    """The private body at another shard width: the same step, exact."""
    res = port_entry._dryrun_body(8, cols=64, device="cpu")
    assert [s for s, _ in res] == _np_step(8, 64)
