"""The port's multi-node planning against the reference's: ras (the
allocation parsers), rmaps (every mapping policy, with and without
oversubscription, classic and hybrid shells) and the PLM's launch
tree, held field by field over a grid; the analogs of
tests/test_multihost.py's planning cases; the simulated node's devices
(the port's one divergence: M logical devices where the reference
forces an M-device CPU platform); the KV proxy's upstream ids; and
the info tool's component inventory against the reference's."""

import itertools
import os
import subprocess
import sys

import pytest

from ompi_tpu.runtime import ras as ref_ras
from ompi_tpu.runtime import rmaps as ref_rmaps
from ompi_tpu.tools.plm import build_tree as ref_build_tree
from ompi_tpu_torch.runtime import ras, rmaps
from ompi_tpu_torch.testing import mpirun_run
from ompi_tpu_torch.tools.plm import build_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EX = os.path.join("ompi_tpu_torch", "examples")


def _nodes(*slots, mod=ras):
    return [mod.Node(name=f"n{i}", slots=s, node_id=i)
            for i, s in enumerate(slots)]


def _outcome(mod_rmaps, mod_ras, slots, np_, rpp, policy, over):
    """The map as plain data, or the ValueError's message."""
    try:
        maps = mod_rmaps.map_ranks(_nodes(*slots, mod=mod_ras), np_, rpp,
                                   policy=policy, oversubscribe=over)
    except ValueError as e:
        return ("error", str(e))
    return [(m.node.name, m.node.node_id, m.node.slots,
             [(p.rank_base, p.nlocal) for p in m.procs], m.ranks)
            for m in maps]


SLOTS = [(1,), (2, 2), (4, 2), (3, 1), (1, 1, 1, 1), (2, 3, 1)]
NPS = [1, 3, 4, 6, 9]
RPPS = [1, 2, 4]


@pytest.mark.parametrize("over", [False, True])
@pytest.mark.parametrize("policy", ["byslot", "bynode", "ppr:2:node",
                                    "ppr:1:node", "seq", "ppr:2:socket",
                                    "spread"])
def test_rmaps_grid_matches_reference(policy, over):
    """Every (slots, np, rpp) of the grid maps to the same launch
    units on the same nodes as the reference's, or raises the same
    ValueError."""
    for slots, np_, rpp in itertools.product(SLOTS, NPS, RPPS):
        port = _outcome(rmaps, ras, slots, np_, rpp, policy, over)
        ref = _outcome(ref_rmaps, ref_ras, slots, np_, rpp, policy, over)
        assert port == ref, (slots, np_, rpp, policy, over)


@pytest.mark.parametrize("over", [False, True])
def test_rmaps_rankfile_matches_reference(tmp_path, over):
    good = tmp_path / "good"
    good.write_text("# placement\nrank 0=n1\nrank 1=n0\n2 n1\nrank 3=n1\n")
    bad = tmp_path / "bad"
    bad.write_text("rank 0=n1\nrank 0=n0\n")
    short = tmp_path / "short"
    short.write_text("rank 0=n1\n")
    for path, np_ in ((good, 4), (bad, 2), (short, 2), (good, 3)):
        for rpp in (1, 2):
            policy = f"rankfile:{path}"
            port = _outcome(rmaps, ras, (2, 2), np_, rpp, policy, over)
            ref = _outcome(ref_rmaps, ref_ras, (2, 2), np_, rpp, policy,
                           over)
            assert port == ref, (path.name, np_, rpp)


def _tree(entries):
    return [(e["name"], e["node"], e["simulated"], e["local"],
             _tree(e["subtree"])) for e in entries]


@pytest.mark.parametrize("radix", [1, 2, 3, 4, 32])
def test_build_tree_matches_reference(radix):
    for n in (1, 2, 5, 13, 40):
        port = build_tree([ras.Node(name=f"n{i}", slots=1, node_id=i,
                                    simulated=i % 2 == 0)
                           for i in range(n)], radix)
        ref = ref_build_tree([ref_ras.Node(name=f"n{i}", slots=1,
                                           node_id=i, simulated=i % 2 == 0)
                              for i in range(n)], radix)
        assert _tree(port) == _tree(ref), (n, radix)


def test_ras_sources_match_reference(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\nn0 slots=2\nlocalhost slots=3  # tail\n\nn2\n")

    def fields(nodes):
        return [(n.name, n.slots, n.node_id, n.simulated, n.local,
                 n.sim_devices) for n in nodes]

    for args in (("a,b:4,localhost:2", None, None, 7),
                 (None, str(hf), None, 7), (None, None, "3x2", 6),
                 (None, None, "4", 4), (None, None, None, 5)):
        assert fields(ras.allocate(*args)) == fields(ref_ras.allocate(*args))
    for bad in (("a", None, "2x2", 4), (None, None, "0x2", 4),
                (None, None, "2y3", 4), ("a:0", None, None, 1)):
        with pytest.raises(ValueError):
            ras.allocate(*bad)
        with pytest.raises(ValueError):
            ref_ras.allocate(*bad)


# ---- the analogs of tests/test_multihost.py's planning cases --------

def test_parse_hosts_slots():
    nodes = ras.parse_hosts("a,b:4,localhost:2")
    assert [n.name for n in nodes] == ["a", "b", "localhost"]
    assert [n.slots for n in nodes] == [1, 4, 2]
    assert nodes[2].local and not nodes[0].local


def test_parse_hostfile(tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\nn0 slots=2\nn1 slots=3  # tail\n\nn2\n")
    nodes = ras.parse_hostfile(str(hf))
    assert [(n.name, n.slots) for n in nodes] == [
        ("n0", 2), ("n1", 3), ("n2", 1)]


def test_parse_simulate():
    nodes = ras.parse_simulate("4x2")
    assert len(nodes) == 4 and all(n.slots == 2 and n.simulated
                                   for n in nodes)
    assert ras.parse_simulate("3")[0].sim_devices == 1
    with pytest.raises(ValueError):
        ras.parse_simulate("0x2")


def test_allocate_sources_exclusive():
    with pytest.raises(ValueError):
        ras.allocate("a,b", None, "2x2", 4)
    default = ras.allocate(None, None, None, 6)
    assert len(default) == 1 and default[0].local \
        and default[0].slots == 6


def test_map_byslot_fills_nodes():
    maps = rmaps.map_ranks(_nodes(2, 2), 3)
    assert maps[0].ranks == [0, 1] and maps[1].ranks == [2]


def test_map_bynode_round_robin():
    maps = rmaps.map_ranks(_nodes(2, 2), 4, policy="bynode")
    assert maps[0].ranks == [0, 2] and maps[1].ranks == [1, 3]


def test_map_oversubscribe_gate():
    with pytest.raises(ValueError):
        rmaps.map_ranks(_nodes(1, 1), 4)
    maps = rmaps.map_ranks(_nodes(1, 1), 4, oversubscribe=True)
    assert sorted(maps[0].ranks + maps[1].ranks) == [0, 1, 2, 3]


def test_map_hybrid_shells():
    maps = rmaps.map_ranks(_nodes(4, 2), 6, rpp=4)
    assert [(p.rank_base, p.nlocal) for p in maps[0].procs] == [(0, 4)]
    assert [(p.rank_base, p.nlocal) for p in maps[1].procs] == [(4, 2)]
    with pytest.raises(ValueError):
        rmaps.map_ranks(_nodes(2, 2), 4, rpp=2, policy="bynode")


def test_map_hybrid_oversubscribed_contiguous():
    """Oversubscribed byslot keeps per-node contiguity (slot-
    proportional shares), so hybrid shells still map."""
    maps = rmaps.map_ranks(_nodes(2, 2), 6, rpp=6, oversubscribe=True)
    assert maps[0].ranks == [0, 1, 2] and maps[1].ranks == [3, 4, 5]
    assert [(p.rank_base, p.nlocal) for p in maps[0].procs] == [(0, 3)]
    maps = rmaps.map_ranks(_nodes(3, 1), 6, oversubscribe=True)
    assert maps[0].ranks == [0, 1, 2, 3, 4] and maps[1].ranks == [5]


def test_launch_tree_covers_all_nodes_once():
    nodes = [ras.Node(name=f"n{i}", slots=1, node_id=i)
             for i in range(13)]
    for radix in (1, 2, 3, 32):
        roots = build_tree(nodes, radix)
        seen = []

        def walk(e):
            seen.append(e["node"])
            for c in e["subtree"]:
                walk(c)

        for r in roots:
            walk(r)
        assert sorted(seen) == list(range(13)), radix
        if radix == 2:
            assert len(roots) == 2  # HNP fan-out respects the radix


def test_explicit_single_node_enforces_slots():
    """--hosts localhost:2 must enforce the slot count even though the
    allocation is one local node (PLM path, not the direct path)."""
    r = mpirun_run(4, os.path.join(EX, "ring.py"),
                   extra=("--hosts", "localhost:2"), timeout=60,
                   job_timeout=30)
    assert r.returncode == 2
    assert "not enough slots" in r.stderr.decode()


# ---- the simulated node's devices (the divergence) ------------------

def test_divergence_simulated_node_devices(monkeypatch):
    """Where the reference forces an M-device CPU platform on each
    simulated node, the port's app shell hands its ranks M logical
    devices: of the CPU with --devices cpu; with --devices auto, of
    card n % count for node n, or M distinct cards when the host has
    N x M of them; no card under auto raises (no rank starts)."""
    import torch

    from ompi_tpu_torch.runtime.state import LogicalDevice
    from ompi_tpu_torch.tools import hostrun

    cpu = torch.device("cpu")
    assert hostrun.shell_devices("cpu", (1, 2, 3)) == [
        LogicalDevice(cpu, s) for s in range(3)]
    assert hostrun.shell_devices("cpu") == [cpu]
    assert hostrun.shell_devices("none", (0, 2, 2)) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for count, node, want in (
            (1, 1, [LogicalDevice(torch.device("cuda", 0), s)
                    for s in range(4)]),
            (2, 3, [LogicalDevice(torch.device("cuda", 1), s)
                    for s in range(4)]),
            (8, 1, [torch.device("cuda", i) for i in range(4, 8)])):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=count: c)
        assert hostrun.shell_devices("auto", (node, 2, 4)) == want, count
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        hostrun.shell_devices("auto", (0, 2, 2))
    # the node env mpirun's daemons pass on
    monkeypatch.setenv("TPUMPI_SIM_DEVICES", "4")
    monkeypatch.setenv("TPUMPI_SIM_NODES", "2")
    monkeypatch.setenv("TPUMPI_NODE", "1")
    assert hostrun.sim_node() == (1, 2, 4)
    monkeypatch.delenv("TPUMPI_SIM_DEVICES")
    assert hostrun.sim_node() is None


def test_kv_proxy_upstream_ids_distinct():
    """A daemon's KV proxy talks upstream with the KV client ids of
    its own process ("pid.tN"), so they can never collide with a rank
    client's (another process) nor with the reference client's
    "pid.N" in a process that loads both."""
    from ompi_tpu.runtime import kvstore as ref_kv
    from ompi_tpu_torch.runtime import kvstore

    server = kvstore.KVServer(2)
    try:
        proxy = kvstore.KVProxy(server.addr, local_expected=2)
        c = kvstore.KVClient(proxy.addr)
        c.put("k", 1)
        assert c.get("k") == 1
        direct = kvstore.KVClient(server.addr)
        ids = [proxy.up._cid, c._cid, direct._cid]
        assert len(set(ids)) == 3
        assert all(i.startswith(f"{os.getpid()}.t") for i in ids)
        assert not ref_kv._next_cid().startswith(f"{os.getpid()}.t")
        c.close()
        direct.close()
    finally:
        server.close()


# ---- info ------------------------------------------------------------

# components the port does not have yet (ROADMAP A9: coll seg, sm and
# inter, pml vprotocol, persistent and monitoring; of these only coll
# sm and seg register as components in the reference's inventory)
UNPORTED = {("coll", "sm"), ("coll", "seg")}


def _components(module):
    r = subprocess.run([sys.executable, "-m", module, "--parsable"],
                       capture_output=True, timeout=120, cwd=REPO,
                       env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert r.returncode == 0, r.stderr.decode()
    lines = r.stdout.decode().splitlines()
    comps = {tuple(ln.split(":")[1:3]): ln.split(":")[-1]
             for ln in lines if ln.startswith("mca:")}
    return lines, comps


def test_info_components_match_reference():
    """The port's ``info --parsable`` inventory is the reference's,
    priorities included, less the components still unported."""
    port_lines, port = _components("ompi_tpu_torch.tools.info")
    _, ref = _components("ompi_tpu.tools.info")
    assert set(ref) - set(port) == UNPORTED
    assert set(port) <= set(ref)
    assert all(port[k] == ref[k] for k in port)
    assert port_lines[0].startswith("version:")
    assert any(ln.startswith("installdirs:prefix:") for ln in port_lines)


def test_info_params_and_pvars():
    from ompi_tpu_torch.tools import info

    info._import_all_components()
    params = info.list_params("coll", "all", parsable=True)
    assert params and all(p.startswith("mca:coll:") for p in params)
    assert any(":param:coll_pipeline_min_bytes:value:" in p for p in params)
    pv = info.list_pvars(parsable=True)
    assert any(":pvar:coll_pipeline_ops:class:counter" in p for p in pv)
    plain = info.list_components(parsable=False)
    assert any(ln.startswith("  ompi:coll: tpu (pri 80)") for ln in plain)
