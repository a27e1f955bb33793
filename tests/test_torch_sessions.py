"""The session plane of the port: cid bands (``ProcState.cid_band``,
``respawn_epoch``, the strides of comm/communicator and the floor of
every cid agreement), ``testing.sessions.run_sessions`` (resident
sessions as concurrent thread worlds of one process, bands 1..k), and
the combined K3 / K6 launches those sessions' fused batches ride, held
against their plain versions on the card (``gpu``-marked: skipped
without one).

The strides are compared with the reference's
(``ompi_tpu.comm.communicator``), and the cids of one program of dup,
split and create_group with both packages' ``run_ranks`` (create_group
is a named divergence: the port floors it into the band).  Two sessions
in bands 1 and 2 must alias in no table keyed by cid: their
communicators' ids, the rendezvous keys, the plan caches, the device
windows' tables, the trace spans' cids and the pvar bands.

Tolerance: exact (integers; the kernels' cases compare bytes).
"""

import numpy as np
import pytest
import torch

from ompi_tpu.comm import communicator as ref_comm
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import osc
from ompi_tpu_torch.coll import device, fusion
from ompi_tpu_torch.comm import communicator as port_comm
from ompi_tpu_torch.kernels import fused, mesh
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks
from ompi_tpu_torch.testing.sessions import run_sessions

CPU = torch.device("cpu")


def test_strides_match_reference():
    assert port_comm.EPOCH_CID_STRIDE == ref_comm.EPOCH_CID_STRIDE
    assert port_comm.MAX_RESPAWN_EPOCHS == ref_comm.MAX_RESPAWN_EPOCHS
    assert port_comm.SESSION_CID_STRIDE == ref_comm.SESSION_CID_STRIDE


def _cid_program(group_cls, band, epoch):
    """A world built in band 0 that then moves to (band, epoch): the
    cids that dup, split and create_group agree on."""
    def fn(comm):
        comm.state.cid_band = band
        comm.state.respawn_epoch = epoch
        a = comm.dup()
        b = comm.split(comm.rank % 2)
        c = comm.create_group(group_cls(list(range(comm.size))))
        return a.cid, b.cid, c.cid
    return fn


BANDS = ((0, 0), (1, 0), (2, 0), (0, 1), (1, 3), (5, 2))


@pytest.mark.parametrize("band,epoch", BANDS)
def test_next_cid_floor_matches_reference(band, epoch):
    """The same program through both packages' ``run_ranks``: dup and
    split agree on the same cids, the reference's floor band *
    SESSION_CID_STRIDE + epoch * EPOCH_CID_STRIDE or the next free cid
    above it; create_group too where the floor is 0."""
    ref = ref_run_ranks(4, _cid_program(ref_comm.Group, band, epoch))
    port = run_ranks(4, _cid_program(port_comm.Group, band, epoch))
    assert [r[:2] for r in port] == [r[:2] for r in ref]
    lo = max(band * ref_comm.SESSION_CID_STRIDE
             + epoch * ref_comm.EPOCH_CID_STRIDE, 2)
    assert [r[:2] for r in ref] == [(lo, lo + 1)] * 4
    if (band, epoch) == (0, 0):
        assert port == ref


@pytest.mark.parametrize("band,epoch", [be for be in BANDS if be != (0, 0)])
def test_create_group_floor_diverges_from_reference(band, epoch):
    """Divergence: the reference's create_group agrees on its members'
    smallest free cids and ignores the band (cid 2 here, in band 0,
    where another session's derived comms may live); the port's floors
    it as next_cid does, so a session's group comms stay in its band."""
    ref = ref_run_ranks(4, _cid_program(ref_comm.Group, band, epoch))
    port = run_ranks(4, _cid_program(port_comm.Group, band, epoch))
    lo = band * ref_comm.SESSION_CID_STRIDE \
        + epoch * ref_comm.EPOCH_CID_STRIDE
    assert [r[2] for r in ref] == [2] * 4
    assert [r[2] for r in port] == [lo + 2] * 4


def test_world_at_the_band_base():
    res = run_ranks(2, lambda c: (c.cid, c.state.comm_self.cid,
                                  c.dup().cid), cid_band=3)
    base = 3 * port_comm.SESSION_CID_STRIDE
    assert res == [(base, base + 1, base + 2)] * 2


def _tables(comm):
    """What one rank of a session leaves in the tables keyed by cid."""
    st = comm.state
    sub = comm.split(comm.rank % 2)
    dup = comm.dup()
    rv_keys = []
    for c in (comm, sub, dup):
        c.allreduce_arr(torch.ones(4), port_op.SUM)
        c.allreduce_arr(torch.ones(4096), port_op.SUM)   # a plan
        rv_keys += [k for k, v in st.rte.world.shared.items()
                    if k[0] == "coll_rv" and v is device._get_rendezvous(c)]
    q = comm.iallreduce_arr(torch.full((3,), 1.0 + comm.rank), port_op.SUM)
    q.wait()
    spans = {e["args"].get("cid") for e in st.tracer.snapshot()
             if "cid" in e.get("args", {})}
    plans = [id(c.__dict__["_coll_plans"]) for c in (comm, sub, dup)]
    return {"cids": {comm.cid, st.comm_self.cid, sub.cid, dup.cid},
            "rv": set(rv_keys), "spans": spans, "plans": plans}


def _window_keys(comm):
    win = osc.allocate(comm, 64)
    key = win._table_key
    win.free()
    return key


def test_two_sessions_alias_in_no_cid_keyed_table():
    """Sessions in bands 1 and 2 at the same time: disjoint cids, and
    so disjoint rendezvous keys, trace-span cids and device-window
    table keys; plan caches of their own; their fused flushes land in
    their own pvar bands."""
    knobs = {"trace_enable": 1, "coll_pipeline_min_bytes": 8192}
    saved = {k: registry.get(k) for k in knobs}
    for k, v in knobs.items():
        registry.set(k, v)
    f1, f2 = (fusion._pv_batches.read_band(b) for b in (1, 2))
    try:
        hbm = run_sessions(2, 4, _tables, device_map=lambda r: CPU,
                           window_us=0)
        win = run_sessions(2, 4, _window_keys,
                           device_map=logical_devices("cpu"), window_us=0)
    finally:
        for k, v in saved.items():
            registry.set(k, v)
    for key in ("cids", "rv", "spans"):
        a = set().union(*(r[key] for r in hbm[0]))
        b = set().union(*(r[key] for r in hbm[1]))
        assert a and b and not a & b, key
    s = port_comm.SESSION_CID_STRIDE
    assert all(s <= c < 2 * s for r in hbm[0] for c in r["cids"])
    assert all(2 * s <= c < 3 * s for r in hbm[1] for c in r["cids"])
    assert not {p for r in hbm[0] for p in r["plans"]} & \
        {p for r in hbm[1] for p in r["plans"]}
    assert not set(win[0]) & set(win[1])
    assert fusion._pv_batches.read_band(1) - f1 == 4
    assert fusion._pv_batches.read_band(2) - f2 == 4


def test_hint_and_window_restored():
    """run_sessions reports k sessions while they run, 0 after, and
    puts the window knob back."""
    before = registry.get("dvm_batch_window_us")
    seen = run_sessions(3, 2, lambda c: fusion._xsession_hint,
                        device_map=lambda r: CPU, window_us=1234)
    assert seen == [[3, 3]] * 3
    assert fusion._xsession_hint == 0
    assert registry.get("dvm_batch_window_us") == before


def test_run_sessions_devices_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal cannot show")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        run_sessions(2, 2, lambda c: None)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        run_sessions(2, 2, lambda c: None, devices=True)
    assert fusion._xsession_hint == 0


# -- the combined kernels on the card ----------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_combined_k3_matches_plain_on_card(cuda_device):
    """Two sessions x 32 slots x 8 ranks of one group in one K3 launch
    equal the plain version byte for byte; 129 slots raise."""
    rng = np.random.default_rng(2)
    slots = [([torch.from_numpy(rng.integers(-99, 99, 4096).astype(
        np.float32)).to(cuda_device) for _ in range(8)],
        (i % 8) if i % 9 == 0 else None) for i in range(64)]
    c0 = fused.fused_batch.launches.value
    got = fused.fused_batch(slots, "MPI_SUM", split=False)
    torch.cuda.synchronize()
    assert fused.fused_batch.launches.value - c0 == 1
    want = fused.fused_batch_plain(slots, "MPI_SUM")
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert torch.equal(a, b)
    with pytest.raises(ValueError):
        fused.fused_batch(slots * 3, "MPI_SUM", split=False)


@pytest.mark.gpu
def test_mesh_allreduce_sets_matches_plain_on_card(cuda_device):
    """K6 over two sets' jobs in one launch a card (``mesh_fold_many``
    with a set a job, split=False; logical devices of one card) equals
    each set's plain fold byte for byte."""
    rng = np.random.default_rng(3)
    sets = [[torch.from_numpy(rng.integers(-99, 99, m).astype(
        np.float32)).to(cuda_device) for _ in range(8)]
        for m in (524288, 524291)]
    c0 = mesh.mesh_fold.launches.value
    got = device._mesh_allreduce_sets(sets, "MPI_SUM", split=False)
    torch.cuda.synchronize()
    assert mesh.mesh_fold.launches.value - c0 == 1
    for xs, per in zip(sets, got):
        want = mesh.mesh_fold_plain(xs, 0, xs[0].numel(), "MPI_SUM")
        for t in per:
            assert torch.equal(t, want)
