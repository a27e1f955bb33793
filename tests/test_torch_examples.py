"""A10's examples through the port (ompi_tpu_torch/examples/
ring_attention.py, rma_counter.py, halo_stencil.py, nbc_overlap.py),
with the reference beside them.

The analog of tests/test_coll_device.py's
``test_ring_attention_example_exact``: the port's torch ring attention
on 4 rank-threads (the hbm route's ``ppermute_arr`` on the CPU) is
full attention at the reference's tolerance (rtol 2e-4, atol 2e-5),
and so is the reference's ring attention on the same Q, K, V (numpy
draws from seed 0); the two outputs agree at that tolerance.  The
other three run under the port's mpirun and print the reference
programs' lines.  The two examples written against the flat MPI_*
surface, ``ring_flat.py`` (on ``mpi.py``) and ``join_prog.py`` (on
``MPI_Comm_join``), run under the port's mpirun and print the lines
the reference's copies (examples/ring_flat.py, tests/_join_prog.py)
print under its own.
"""

import importlib.util
import os

import numpy as np
import pytest

from ompi_tpu_torch.examples import ring_attention as port_ra
from ompi_tpu_torch.testing import mpirun_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join("ompi_tpu_torch", "examples")


def _ref_module():
    spec = importlib.util.spec_from_file_location(
        "ref_ring_attention", os.path.join(REPO, "examples",
                                           "ring_attention.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ring_attention_example_exact():
    """Ring attention via ppermute_arr is EXACT full attention over the
    comm-wide sequence, in both packages, on the same inputs."""
    import jax.numpy as jnp

    from ompi_tpu.testing import run_ranks as ref_run_ranks
    nranks, sq, d = 4, 8, 16
    outs, err, _cold, _warm = port_ra.run("cpu", nranks, sq, d)
    assert err <= 1e-5
    ref = _ref_module()
    Q, K, V = port_ra.inputs(nranks, sq, d)

    def fn(comm):
        r = comm.rank
        q, k, v = (jnp.asarray(a[r * sq:(r + 1) * sq]) for a in (Q, K, V))
        return np.asarray(ref.ring_attention(comm, q, k, v))

    ref_outs = ref_run_ranks(nranks, fn, devices=True)
    want = port_ra.reference_attention(Q, K, V)
    for r in range(nranks):
        shard = want[r * sq:(r + 1) * sq]
        np.testing.assert_allclose(outs[r].numpy(), shard,
                                   rtol=port_ra.RTOL, atol=port_ra.ATOL)
        np.testing.assert_allclose(outs[r].numpy(), ref_outs[r],
                                   rtol=port_ra.RTOL, atol=port_ra.ATOL)
    port_ra.main(["--device", "cpu"])


@pytest.mark.parametrize("prog,np_,want", [
    ("rma_counter.py", 4, ["rma_counter OK on 4 ranks"]),
    ("halo_stencil.py", 4, [
        f"rank {r} coords [{r // 2}, {r % 2}] halo-mean 1.50 "
        f"interior-mean {float(r):.2f}" for r in range(4)]),
    ("nbc_overlap.py", 4, ["nbc_overlap OK on 4 ranks"]),
])
def test_example_under_mpirun(prog, np_, want):
    r = mpirun_run(np_, os.path.join(EX, prog), timeout=100,
                   job_timeout=70)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    lines = r.stdout.decode().splitlines()
    for w in want:
        assert w in lines, (w, lines)


def test_halo_stencil_device_halo_on_rank_threads():
    """halo_stencil.py with a device a rank (one app shell of rank-
    threads on the CPU): the east edge's ``sendrecv_arr`` lands on the
    neighbour's device, and the lines are the host run's."""
    r = mpirun_run(4, os.path.join(EX, "halo_stencil.py"), rpp="all",
                   devices="cpu", timeout=100, job_timeout=70)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    # rank-threads share the shell's stdout: a print's text and its
    # newline are two writes, so lines may interleave at their ends
    out = r.stdout.decode()
    for k in range(4):
        assert (f"rank {k} coords [{k // 2}, {k % 2}] halo-mean 1.50 "
                f"interior-mean {float(k):.2f}") in out, out
    assert out.count("halo-mean") == 4


@pytest.mark.parametrize("prog,ref_prog,np_", [
    ("ring_flat.py", os.path.join("examples", "ring_flat.py"), 4),
    ("join_prog.py", os.path.join("tests", "_join_prog.py"), 2),
])
def test_flat_surface_example_matches_reference(prog, ref_prog, np_):
    """The examples written against the flat MPI_* surface (the port's
    ``mpi.py``; ``MPI_Comm_join``) print, under the port's mpirun, the
    lines the reference's copies print under its own."""
    from ompi_tpu.testing import mpirun_run as ref_mpirun_run
    outs = []
    for run, path in ((mpirun_run, os.path.join(EX, prog)),
                      (ref_mpirun_run, ref_prog)):
        r = run(np_, path, timeout=100, job_timeout=70)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        outs.append(sorted(r.stdout.decode().splitlines()))
    assert outs[0] == outs[1]
    assert outs[0], "the example printed nothing"
