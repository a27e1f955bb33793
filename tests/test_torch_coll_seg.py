"""coll/seg through the port (ompi_tpu_torch/coll/seg.py): shared-
segment collectives between same-node process ranks, the native C
path over native/collseg.cpp (built by ompi_tpu_torch/native.py) and
the interoperable Python protocol, with the reference beside it.

The analogs of tests/test_coll_seg.py's 6 tests (the tails matrix
parametrised as there).  The port's ``examples/collseg_prog.py`` and
``collseg_tails_prog.py`` keep the reference programs' checks; the
reference's ``tests/_collseg_prog.py`` runs under the reference's
mpirun beside the port's (same rank count, the same checks), and each
port rank's ``SEGDIGEST`` — its results on integer vectors drawn from
a seed — equals the digest of numpy's rank-order reduction of the
same draws, which is the p2p route's result byte for byte.  The
``coll_seg_native_ops`` / ``python_ops`` pvars say which path served.
"""

import json
import os
import subprocess
import sys

import pytest

from ompi_tpu_torch.testing import collseg_digest, mpirun_run

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join("ompi_tpu_torch", "examples")
PROG = os.path.join(EX, "collseg_prog.py")
TAILS = os.path.join(EX, "collseg_tails_prog.py")


def _ref(np_, *args):
    """The reference's program under the reference's mpirun."""
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu.tools.mpirun", "-np", str(np_),
         "--timeout", "100", os.path.join(REPO, "tests", "_collseg_prog.py"),
         *args], capture_output=True, timeout=130, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu",
             "PYTHONPATH": REPO + os.pathsep + os.environ.get(
                 "PYTHONPATH", "")})
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"collseg ok" in r.stdout and b"collseg chunked ok" in r.stdout


def _run(np_, *args, native=True, ref=False):
    r = mpirun_run(np_, PROG, *args, timeout=130, job_timeout=100)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    out = r.stdout.decode()
    assert "collseg ok" in out and "collseg chunked ok" in out
    want = collseg_digest(np_)
    digests = sorted(ln for ln in out.splitlines()
                     if ln.startswith("SEGDIGEST"))
    assert digests == [f"SEGDIGEST rank={k} {want}" for k in range(np_)]
    pv = [dict(kv.split("=") for kv in ln.split()[1:])
          for ln in out.splitlines() if ln.startswith("SEGPVAR")]
    assert len(pv) == np_
    for p in pv:
        if native:
            assert int(p["native"]) > 0 and int(p["python"]) == 0, pv
        else:
            assert int(p["native"]) == 0 and int(p["python"]) > 0, pv
    if ref:
        _ref(np_, *args)


def test_collseg_native_all_ops_8_ranks():
    _run(8, ref=True)


def test_collseg_native_non_power_of_two():
    _run(5)


def test_collseg_python_protocol_fallback():
    """The Python protocol path (native disabled in-process) must
    produce identical results through the same segment layout."""
    _run(4, "--python-path", native=False, ref=True)


def test_collseg_two_ranks():
    _run(2)


@pytest.mark.parametrize("rem", [0, 1, -1],
                         ids=["exact", "plus1", "piece-minus1"])
def test_collseg_chunked_tail_matrix(rem):
    """Tail-segment audit: chunked allreduce/bcast counts with count %
    piece in {0, 1, piece-1} across int8/float16/float32/float64, on a
    non-power-of-two comm — the ragged remainder must round-trip
    exactly and the P-divisible head must still take the split rs+ag
    rounds."""
    r = mpirun_run(5, TAILS, str(rem),
                   mca=(("coll_seg_slot_bytes", "16384"),),
                   timeout=130, job_timeout=100)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"collseg tails ok" in r.stdout, \
        r.stdout.decode()[-500:] + r.stderr.decode()[-1500:]


def test_native_path_engages_under_mpirun():
    """The C segment hot path serves mpirun process ranks (the native
    library built into build/ompi_tpu_torch/native/ has the collseg
    symbols), and a job with ``--mca coll ^seg`` takes the p2p route
    with the same result."""
    from ompi_tpu_torch import native
    lib = native.load()
    assert lib is not None and hasattr(lib, "tpumpi_seg_coll")
    assert native.lib_path().startswith(
        os.path.join(REPO, "build", "ompi_tpu_torch", "native"))
    for mca, provider in (((), "seg"), ((("coll", "^seg"),), "tuned")):
        r = mpirun_run(4, PROG, "--bench", "1", "3", mca=mca, timeout=130,
                       job_timeout=100)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        row = json.loads(r.stdout.decode().strip().splitlines()[-1])
        assert row["provider"] == provider and row["exact"], row
