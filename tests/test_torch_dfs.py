"""dfs through both packages: read-only access to a file on another
host of the job, over the KV control plane (ompi_tpu.runtime.dfs and
its port, ompi_tpu_torch.runtime.dfs; orte/mca/dfs/app analog).

The analogs of tests/test_dfs.py's 3 tests: the local posix route, and
the dfs program under each package's mpirun — on one host, and on
two simulated nodes whose node proxies forward the launch host's
file.  The port runs ompi_tpu_torch/examples/dfs_prog.py, the
reference tests/_dfs_prog.py; both read the same file and print
``dfs ok``.

Tolerance: exact (bytes).
"""

import importlib
import os

import numpy as np
import pytest

PROGS = {"ompi_tpu_torch": os.path.join("ompi_tpu_torch", "examples",
                                        "dfs_prog.py"),
         "ompi_tpu": os.path.join("tests", "_dfs_prog.py")}


@pytest.fixture(params=["ompi_tpu_torch", "ompi_tpu"], ids=["port", "ref"])
def pkg(request):
    return request.param


@pytest.fixture
def datafile(tmp_path):
    p = tmp_path / "input.bin"
    p.write_bytes(bytes(i % 256 for i in range(3000)))
    return str(p)


def test_dfs_local_posix_route(pkg, tmp_path):
    dfs = importlib.import_module(f"{pkg}.runtime.dfs")
    data = np.random.default_rng(5).integers(0, 256, 3000,
                                             dtype=np.uint8).tobytes()
    path = tmp_path / "rand.bin"
    path.write_bytes(data)
    with dfs.open(str(path)) as f:
        assert f.size() == 3000
        assert f.read(5) == data[:5]
        assert f.tell() == 5
        assert f.pread(100, 7) == data[100:107] and f.tell() == 5
        f.seek(-4, dfs.SEEK_END)
        assert f.read() == data[-4:]
        f.seek(-10, dfs.SEEK_CUR)
        assert f.read(3) == data[2990:2993]
        with pytest.raises(OSError):
            f.seek(1, dfs.SEEK_END)
    with pytest.raises(OSError, match="no control plane"):
        dfs.open("file://otherhost/etc/hosts")


def _run(pkg, n, datafile, extra=()):
    run = importlib.import_module(f"{pkg}.testing").mpirun_run
    r = run(n, PROGS[pkg], datafile, extra=extra, timeout=240,
            job_timeout=200)
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    return r.stdout.decode().splitlines()


def test_dfs_through_kv_single_host(pkg, datafile):
    assert "dfs ok" in _run(pkg, 2, datafile)


def test_dfs_forwarded_through_node_proxy(pkg, datafile):
    """Simulated multi-node: ranks sit behind per-node daemons whose
    KV proxies must forward the hnp-host dfs requests upstream."""
    assert "dfs ok" in _run(pkg, 4, datafile,
                            extra=("--simulate-nodes", "2x2"))
