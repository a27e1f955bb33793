"""The port's locality layer (runtime/topology.py, runtime/reachable.py,
copied from the reference): topology detection (hwloc analog), binding
(rtc analog), NIC scoring (if/reachable analog) — the analog of
tests/test_topology.py, with each answer held against the
reference's on this machine."""

import os

import pytest

from ompi_tpu.runtime import reachable as ref_reachable
from ompi_tpu.runtime import topology as ref_topology
from ompi_tpu_torch.runtime import reachable, topology


def test_detect_reports_real_cpus():
    t = topology.detect()
    assert t.ncpus >= 1
    assert t.ncores >= 1
    assert t.nnuma >= 1
    assert len(t.core_groups()) == t.ncores
    # every cpu appears in exactly one core group
    flat = [c for g in t.core_groups() for c in g]
    assert sorted(flat) == sorted(c.cpu for c in t.cpus)
    assert "core" in t.summary()


def test_numa_cpu_maps_consistent():
    t = topology.detect()
    for nid in t.numa_nodes:
        assert t.cpus_of_numa(nid)


def test_bind_core_applies_affinity():
    t = topology.detect()
    before = os.sched_getaffinity(0)
    try:
        applied = topology.apply_binding(0, "core")
        assert applied is not None
        assert set(applied) == os.sched_getaffinity(0)
        assert set(applied) <= {c.cpu for c in t.cpus}
    finally:
        os.sched_setaffinity(0, before)


def test_bind_none_is_noop():
    assert topology.apply_binding(0, "none") is None


def test_bind_unknown_raises():
    with pytest.raises(ValueError):
        topology.apply_binding(0, "sockets")


def test_device_order_snakes_torus():
    class D:
        def __init__(self, id, coords):
            self.id = id
            self.coords = coords

    # 2x2 torus: snake order keeps consecutive devices adjacent
    devs = [D(0, (0, 0)), D(1, (1, 1)), D(2, (0, 1)), D(3, (1, 0))]
    ordered = topology.device_order_for_locality(devs)
    coords = [d.coords for d in ordered]
    assert coords == [(0, 0), (0, 1), (1, 1), (1, 0)]
    for a, b in zip(coords, coords[1:]):
        assert sum(abs(x - y) for x, y in zip(a, b)) == 1  # 1 ICI hop


def test_interfaces_enumerate_with_masks():
    ifs = reachable.interfaces()
    assert ifs
    lo = [i for i in ifs if i.loopback]
    assert lo and lo[0].ip == "127.0.0.1"
    for i in ifs:
        assert i.network is not None


def test_weighted_scoring_prefers_same_network():
    eth = reachable.Interface("eth0", "10.0.0.2", "255.255.255.0",
                              True, 10000, 1500)
    same_net = reachable.score_pair(eth, "10.0.0.7")
    same_kind = reachable.score_pair(eth, "192.168.9.9")
    other = reachable.score_pair(eth, "8.8.8.8")
    assert same_net > same_kind > other > 0
    down = reachable.Interface("eth1", "10.0.0.3", "255.255.255.0",
                               False, 10000, 1500)
    assert reachable.score_pair(down, "10.0.0.7") == 0
    lo = reachable.Interface("lo", "127.0.0.1", "255.0.0.0", True,
                             -1, 65536)
    assert reachable.score_pair(lo, "10.0.0.7") == 0  # lo never routes


def test_pick_remote_addr_scores_matrix():
    # loopback is reachable (same host); an unroutable peer net still
    # picks the best candidate
    assert reachable.pick_remote_addr(["127.0.0.1"]) == "127.0.0.1"
    got = reachable.pick_remote_addr(["127.0.0.1", "10.1.2.3"])
    assert got is not None


def test_detection_matches_reference():
    t, r = topology.detect(), ref_topology.detect()
    assert t.summary() == r.summary()
    assert t.core_groups() == r.core_groups()
    assert [(i.name, i.ip, i.netmask) for i in reachable.interfaces()] == \
        [(i.name, i.ip, i.netmask) for i in ref_reachable.interfaces()]
    assert reachable.pick_remote_addr(["127.0.0.1", "10.1.2.3"]) == \
        ref_reachable.pick_remote_addr(["127.0.0.1", "10.1.2.3"])


def test_device_order_of_torch_devices_keeps_index_order():
    """torch devices carry no torus coordinates: the order is theirs."""
    import torch
    devs = [torch.device("cuda", i) for i in (0, 1, 2, 3)]
    assert topology.device_order_for_locality(devs) == devs
