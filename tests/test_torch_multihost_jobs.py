"""Multi-node jobs through the port's launcher on the CPU: simulated-node
daemons, the tree launch through the local ssh shim (``--hosts``,
``--hostfile``), IOF relay, failure propagation, the per-node KV
proxy, ``--preload`` and the hierarchical allreduce across simulated
nodes — the analogs of tests/test_multihost.py's job cases, through
``python -m ompi_tpu_torch.tools.mpirun``.  Every job carries its own
``--timeout``."""

import json
import os
import re
import sys

from ompi_tpu_torch.testing import mpirun_run

EX = os.path.join("ompi_tpu_torch", "examples")
LOCALSSH = f"{sys.executable} -m ompi_tpu_torch.tools.localssh"


def run(np_, prog, *args, extra=(), **kw):
    kw.setdefault("timeout", 120)
    kw.setdefault("job_timeout", 60)
    return mpirun_run(np_, os.path.join(EX, prog), *args, extra=extra, **kw)


def test_sim_nodes_ring():
    r = run(4, "ring.py", extra=("--simulate-nodes", "2x2", "--tag-output"))
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode()
    assert "received token 7 from 3" in out
    assert "[sim1:" in out  # IOF relays through the remote daemon


def test_sim_nodes_connectivity():
    r = run(4, "connectivity.py", extra=("--simulate-nodes", "4x1"))
    assert r.returncode == 0, r.stderr.decode()
    assert "PASSED" in r.stdout.decode()


def test_sim_nodes_bynode_mapping_runs():
    r = run(4, "connectivity.py",
            extra=("--simulate-nodes", "2x2", "--map-by", "bynode"))
    assert r.returncode == 0, r.stderr.decode()
    assert "PASSED" in r.stdout.decode()


def test_sim_nodes_hybrid_device_collective():
    """A device collective in a multi-node job: each simulated node's
    shell holds its ranks on M logical devices of the CPU, so the node
    comm takes the mesh tier (coll/tpu, the offload pvar counts), and
    the leaders combine the partials over tcp — the reference's
    result, rank by rank."""
    r = run(4, "hier_allreduce.py", rpp="all", devices="cpu",
            extra=("--simulate-nodes", "2x2"))
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode()
    assert out.count("hierarchical allreduce ok") == 4
    assert "device-offloaded=0" not in out


def test_sim_nodes_hier_allreduce_measured():
    """hier_allreduce.py --bytes/--iters at 2x4: one JSON line a node,
    the node comm on the mesh tier, the result within the float SUM
    band (checked in the program), every step timed; on the CPU the
    kernels take their plain versions, so no launch is counted."""
    r = run(8, "hier_allreduce.py", "--bytes", str(1 << 16), "--iters", "3",
            rpp="all", devices="cpu", extra=("--simulate-nodes", "2x4"))
    assert r.returncode == 0, r.stderr.decode()
    docs = sorted((json.loads(ln) for ln in r.stdout.decode().splitlines()
                   if ln.startswith("{")), key=lambda d: d["node"])
    assert [d["node"] for d in docs] == [0, 1]
    for d in docs:
        assert d["ranks"] == d["shell_ranks"] == 4
        assert d["node_provider"] == "tpu" and d["offloaded"] > 0
        assert d["ops"] == 3 and d["device"] == "cpu"
        assert set(d["launches"].values()) == {0}
        assert 0 < d["us_node_allreduce"] and 0 < d["us_leaders_allreduce"]
        assert 0 < d["us_node_bcast"] and 0 < d["us_per_op"]
        assert d["max_err"] <= 8 * 2.0 ** -24 * 8


def test_hosts_localssh_tree_launch():
    """--hosts with an ssh-style agent (shimmed local), tree radix 1
    so the second daemon is launched BY the first (plm tree spawn)."""
    r = run(4, "ring.py", extra=("--hosts", "A:2,B:2",
                                 "--launch-agent", LOCALSSH,
                                 "--tree-radix", "1"))
    assert r.returncode == 0, r.stderr.decode()
    assert "received token 7 from 3" in r.stdout.decode()


def test_hostfile_localssh_launch(tmp_path):
    """--hostfile through the shim: three nodes of the file, the
    fan-out at radix 2 (the third daemon tree-spawned by the first)."""
    hf = tmp_path / "hosts"
    hf.write_text("# three nodes\nA slots=2\nB slots=1\nC slots=1\n")
    r = run(4, "connectivity.py",
            extra=("--hostfile", str(hf), "--launch-agent", LOCALSSH,
                   "--tree-radix", "2", "--tag-output"))
    assert r.returncode == 0, r.stderr.decode()
    out = r.stdout.decode()
    assert "PASSED" in out and "[A:0]" in out


def test_sim_nodes_abort_propagates():
    r = run(4, "abort_test.py", extra=("--simulate-nodes", "2x2"))
    assert r.returncode == 42, (r.returncode, r.stderr.decode())
    assert "MPI_Abort" in r.stderr.decode()


def test_sim_nodes_nonzero_exit_kills_job():
    r = run(3, "exit_one.py", extra=("--simulate-nodes", "3x1"))
    assert r.returncode == 7, (r.returncode, r.stderr.decode())
    assert "terminating job" in r.stderr.decode()


def test_kv_proxy_aggregates_connections():
    """The per-node KV proxy (grpcomm analog) collapses per-rank KV
    traffic: with 8 ranks on 2 simulated nodes the central server sees
    at most 2 upstream channels per daemon (ops + fence)."""
    r = run(8, "hello.py", devices="none",
            extra=("--simulate-nodes", "2x4", "--verbose", "kv"))
    assert r.returncode == 0, r.stderr.decode()
    err = r.stderr.decode()
    m = re.search(r"kv server served (\d+) connections", err)
    assert m, err
    served = int(m.group(1))
    assert served <= 4, f"expected O(daemons) connections, saw {served}"
    assert r.stdout.decode().count("Hello") == 8


def test_preload_stages_program_to_nodes(tmp_path):
    """filem/raw analog: --preload ships the program bytes in the
    launch message; daemons run the staged copy from their session
    dir."""
    prog = tmp_path / "myprog.py"
    prog.write_text(
        "import os\n"
        "import ompi_tpu_torch\n"
        "comm = ompi_tpu_torch.init()\n"
        "print('RAN', comm.rank, os.path.abspath(__file__), flush=True)\n"
        "ompi_tpu_torch.finalize()\n")
    r = mpirun_run(2, str(prog), devices="none", timeout=120,
                   job_timeout=60,
                   extra=("--simulate-nodes", "2x1", "--preload"))
    assert r.returncode == 0, r.stderr.decode()
    ran = [ln for ln in r.stdout.decode().splitlines()
           if ln.startswith("RAN")]
    assert len(ran) == 2
    for ln in ran:
        path = ln.split()[-1]
        assert str(prog) != path
        assert os.path.basename(path) == "staged_myprog.py"


PROBE = """
import json, sys
import ompi_tpu_torch
from ompi_tpu_torch.comm.communicator import COMM_TYPE_SHARED
from ompi_tpu_torch.op import op
import torch
comm = ompi_tpu_torch.init()
node = comm.split_type(COMM_TYPE_SHARED)
y = node.allreduce_arr(torch.ones(8, device=comm.device), op.SUM)
st = comm.state
with open(sys.argv[1] + "/r%d.json" % comm.rank, "w") as fh:
    json.dump({"device": str(st.device), "slot": st.device_slot,
               "node": st.rte.node_id, "node_size": node.size,
               "provider": node.coll.providers["allreduce_arr"],
               "sum": float(y[0])}, fh)
ompi_tpu_torch.finalize()
"""


def test_divergence_simulated_nodes_logical_devices(tmp_path):
    """The port's simulated node (--simulate-nodes 2x2, --devices cpu)
    gives its two ranks two logical devices of the CPU, slots 0 and 1
    on each node, so the node comm takes the mesh tier (the reference
    forces a 2-device CPU platform on each node instead); --devices
    auto with no card starts no rank."""
    prog = tmp_path / "probe.py"
    prog.write_text(PROBE)
    r = mpirun_run(4, str(prog), str(tmp_path), rpp="all", devices="cpu",
                   timeout=120, job_timeout=60,
                   extra=("--simulate-nodes", "2x2"))
    assert r.returncode == 0, r.stderr.decode()
    got = [json.loads((tmp_path / f"r{k}.json").read_text())
           for k in range(4)]
    assert [(d["node"], d["slot"]) for d in got] == [(0, 0), (0, 1),
                                                     (1, 0), (1, 1)]
    for d in got:
        assert d["device"] == "cpu" and d["node_size"] == 2
        assert d["provider"] == "tpu" and d["sum"] == 2.0
    import torch
    if not torch.cuda.is_available():
        r = mpirun_run(4, str(prog), str(tmp_path / "none"), rpp="all",
                       devices="auto", timeout=120, job_timeout=60,
                       extra=("--simulate-nodes", "2x2"))
        assert r.returncode != 0
        assert "no CUDA card" in r.stderr.decode()
        assert not (tmp_path / "none").exists()
