"""Self-healing respawn through the port (ompi_tpu_torch/ft/respawn +
cr/buddy), with the reference beside it: a killed rank is replaced
in-job under its world rank, restores from a partner's in-memory buddy
checkpoint, and the job finishes at full size byte-identical to a
fault-free run.

The thread-world cases of tests/test_respawn.py.  The application
loop runs the same steps in both packages from the same inputs; its
state is numpy on the host path (as the reference's test) and a
tensor on both of the port's device tiers on the CPU (``lambda r:
torch.device("cpu")``, ``logical_devices("cpu")``: the kernels' plain
versions), checkpointed every step.  Tolerance: bytes — every value is
a float sum of small integers, exact in any order.  Kills are
``kill_now`` at a named step.

Not here: ``test_kv_purge_op`` tests the KV store, which the port does
not have yet (ROADMAP.md A8).  Pinned divergence: ``rejoin`` runs
without the reference's ``ckpt.ft_abort`` call until the filesystem
tier exists (``test_divergence_rejoin_without_ckpt_ft_abort``).
"""

import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ompi_tpu import ft_inject as ref_fi
from ompi_tpu.cr import buddy as ref_buddy
from ompi_tpu.ft import respawn as ref_respawn
from ompi_tpu.ft import ulfm as ref_ulfm
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import errhandler as eh
from ompi_tpu_torch import ft_inject
from ompi_tpu_torch.comm.communicator import (EPOCH_CID_STRIDE,
                                              SESSION_CID_STRIDE)
from ompi_tpu_torch.cr import buddy
from ompi_tpu_torch.ft import respawn, ulfm
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks

FT = (eh.ERR_PROC_FAILED, eh.ERR_PROC_FAILED_PENDING, eh.ERR_REVOKED)
PORT = (respawn, buddy, ulfm, port_op, eh.MPIException)
REF = (ref_respawn, ref_buddy, ref_ulfm, ref_op,
       __import__("ompi_tpu.errhandler", fromlist=["x"]).MPIException)
TIERS = {"hbm": lambda r: torch.device("cpu"),
         "mesh": logical_devices("cpu")}


class knobs:
    """Set MCA knobs in both registries; restore on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (registry, ref_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)


@pytest.fixture
def buddy_degree_1():
    with knobs({"cr_buddy_degree": "1"}):
        yield


def _make_fn(pkg, iters=8, kill_at=None, tensor=False):
    """App loop with per-iteration buddy checkpoints.  ``kill_at``
    maps rank -> iteration at which the ORIGINAL incarnation dies.
    ``tensor``: the state and the step run as tensors on the rank's
    device through ``allreduce_arr`` (the port only); else numpy on
    the host path."""
    rsp, bdy, ul, op, exc = pkg
    kill_at = kill_at or {}

    def step(i, acc, comm):
        if tensor:
            x = torch.full((4,), (comm.rank + 1.0) * (i + 1),
                           dtype=torch.float64, device=comm.state.device)
            return acc + comm.allreduce_arr(x, op.SUM)
        x = np.full(4, (comm.rank + 1.0) * (i + 1))
        r = np.empty_like(x)
        comm.Allreduce(x, r, op.SUM)
        return acc + r

    def fresh(comm):
        if tensor:
            return torch.zeros(4, dtype=torch.float64,
                               device=comm.state.device)
        return np.zeros(4)

    def restore(comm):
        st = bdy.restore(comm)
        acc = st["acc"]
        if tensor:
            assert isinstance(acc, torch.Tensor)
            assert acc.device == comm.state.device
        return int(st["i"]), acc

    def fn(comm):
        state = comm.state
        was_joining = rsp.joining(state)
        if was_joining:
            comm = rsp.rejoin(comm)
            i, acc = restore(comm)
        else:
            i, acc = 0, fresh(comm)
        did_kill = False
        while i < iters:
            try:
                bdy.checkpoint(comm, {"i": i, "acc": acc})
                if (not was_joining and not did_kill
                        and kill_at.get(comm.rank) == i):
                    did_kill = True
                    ul.kill_now(state)
                acc = step(i, acc, comm)
                i += 1
            except exc as e:
                if e.code not in FT:
                    raise
                comm = rsp.rejoin(comm)
                i, acc = restore(comm)
        out = acc.cpu().numpy() if tensor else acc
        return out.tobytes()
    return fn


# ---- the tentpole: kill -> respawn -> buddy restore -----------------

def test_respawn_byte_identical_full_size(buddy_degree_1):
    """4 ranks, rank 1 killed mid-run: under respawn the job completes
    at FULL world size with results byte-identical to a fault-free
    run of either package — the replacement's state came from a
    partner's memory (no filesystem store in this test at all)."""
    clean = run_ranks(4, _make_fn(PORT), timeout=60)
    ref = ref_run_ranks(4, _make_fn(REF), timeout=60)
    faulty = run_ranks(4, _make_fn(PORT, kill_at={1: 5}), timeout=60,
                       respawn=True)
    assert faulty == clean == ref
    assert all(r is not None for r in faulty)


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_respawn_device_state_byte_identical(buddy_degree_1, tier):
    """The same loop with its state a tensor on the rank's device and
    its step a device allreduce: the replacement rebinds to the dead
    rank's device, restores its tensor there, and the run's bytes
    equal the fault-free run's (and the reference's host run's)."""
    dm = TIERS[tier]
    clean = run_ranks(4, _make_fn(PORT, tensor=True), device_map=dm,
                      timeout=60)
    faulty = run_ranks(4, _make_fn(PORT, kill_at={1: 5}, tensor=True),
                       device_map=dm, timeout=60, respawn=True)
    ref = ref_run_ranks(4, _make_fn(REF), timeout=60)
    assert faulty == clean == ref


def test_respawn_chaos_victim_list(buddy_degree_1):
    """Repeated kills across a run, victims drawn from the
    ft_inject_victim_rank comma list: each original incarnation dies
    at a distinct iteration, each death is recovered by its own rejoin
    epoch, and the result still matches the fault-free run."""
    with knobs({"ft_inject_victim_rank": "1,3"}):
        victims = ft_inject.victim_ranks(4)
        assert victims == ref_fi.victim_ranks(4) == [1, 3]
        kill_at = {v: 2 + 3 * k for k, v in enumerate(victims)}
        clean = run_ranks(4, _make_fn(PORT, iters=10), timeout=60)
        faulty = run_ranks(4, _make_fn(PORT, iters=10, kill_at=kill_at),
                           timeout=60, respawn=True)
    assert faulty == clean


def test_respawn_survives_a_late_failure_record(buddy_degree_1,
                                                monkeypatch):
    """The dead rank's failure record reaches the last survivor 0.5 s
    after the others: that survivor enters rejoin through the first
    survivor's revoke, before its own record of the death arrived.
    It must not un-fail the rank before the record lands, or the late
    record fails the replacement again and the restore on the new
    communicator raises MPI_ERR_PROC_FAILED.  The run still equals
    the fault-free run."""
    deliver = ulfm.UlfmState.deliver

    def late(self, rec):
        if rec[0] == "fail" and self.state.rank == 3:
            time.sleep(0.5)
        deliver(self, rec)

    clean = run_ranks(4, _make_fn(PORT), timeout=60)
    monkeypatch.setattr(ulfm.UlfmState, "deliver", late)
    faulty = run_ranks(4, _make_fn(PORT, kill_at={1: 5}), timeout=60,
                       respawn=True)
    assert faulty == clean


def test_respawn_pvars_count_rejoins(buddy_degree_1):
    before = respawn._pv_rejoins.read()
    run_ranks(4, _make_fn(PORT, kill_at={2: 3}), timeout=60, respawn=True)
    # 3 survivors + 1 replacement each completed one rejoin
    assert respawn._pv_rejoins.read() - before >= 4
    assert respawn._pv_rejoin_us.read() > 0
    assert buddy._pv_ckpts.read() > 0 and buddy._pv_us.read() > 0


def test_divergence_rejoin_without_ckpt_ft_abort():
    """The reference's rejoin first drops an in-flight filesystem
    checkpoint epoch (``ckpt.ft_abort``); the port has no filesystem
    tier (cr/ckpt.py, ROADMAP.md A9), so no epoch can be in flight and
    rejoin reaches for none: the port's cr package has no ckpt module,
    and a rejoin completes without one."""
    import importlib.util
    import inspect
    assert importlib.util.find_spec("ompi_tpu_torch.cr.ckpt") is None
    assert "ft_abort" in inspect.getsource(ref_respawn.rejoin)
    assert "ft_abort(" not in inspect.getsource(respawn.rejoin)
    with knobs({"cr_buddy_degree": "1"}):
        out = run_ranks(3, _make_fn(PORT, iters=4, kill_at={2: 1}),
                        timeout=60, respawn=True)
        ref = ref_run_ranks(3, _make_fn(REF, iters=4), timeout=60)
    assert out == ref


# ---- cr/buddy on its own --------------------------------------------

def test_buddy_roundtrip_without_failure(buddy_degree_1):
    def fn(comm, bdy):
        s1 = bdy.checkpoint(comm, {"v": comm.rank * 1.0})
        s2 = bdy.checkpoint(comm, {"v": comm.rank + 100.0})
        assert (s1, s2) == (0, 1)
        return bdy.restore(comm)["v"]

    assert run_ranks(3, lambda c: fn(c, buddy)) == \
        ref_run_ranks(3, lambda c: fn(c, ref_buddy)) == [100.0, 101.0,
                                                         102.0]


def test_buddy_partner_placement(buddy_degree_1):
    """Copy k of rank r lives on (r + k) % size: the held map, in
    both packages."""
    def fn(comm, bdy):
        bdy.checkpoint(comm, {"r": comm.rank}, degree=2)
        held = sorted(k[0] for k in comm.state.extra["cr_buddy"]["held"])
        want = sorted({(comm.rank - 1) % comm.size,
                       (comm.rank - 2) % comm.size})
        assert held == want, (held, want)
        return bdy.committed_seq(comm.state)

    assert run_ranks(4, lambda c: fn(c, buddy)) == \
        ref_run_ranks(4, lambda c: fn(c, ref_buddy)) == [0, 0, 0, 0]


def test_buddy_ring_offsets_match_reference():
    for nodes in ([0, 0, 0, 0], [0, 0, 1, 1], [0, 1, 0, 1],
                  [0, 0, 0, 1, 1, 1, 2, 2], [3, 1, 2, 3, 1, 2]):
        for deg in (1, 2, 3):
            assert buddy.ring_offsets(nodes, deg) == \
                ref_buddy.ring_offsets(nodes, deg), (nodes, deg)


def test_buddy_degree_zero_is_noop():
    """cr_buddy_degree=0 (the default): checkpoint is a single int
    check — no quiesce, no pickle, no replica state, no traffic."""
    def fn(comm):
        big = torch.zeros(1 << 16)
        assert buddy.checkpoint(comm, {"big": big}) == -1
        assert "cr_buddy" not in comm.state.extra
        return True

    assert run_ranks(2, fn) == [True, True]


def test_buddy_restore_none_before_any_commit(buddy_degree_1):
    assert run_ranks(2, buddy.restore) == \
        ref_run_ranks(2, ref_buddy.restore) == [None, None]


def test_buddy_restore_raises_on_a_corrupt_replica(buddy_degree_1):
    """A replica that fails its CRC makes every rank raise together
    (the agreed verdict), in both packages."""
    def fn(comm, bdy):
        bdy.checkpoint(comm, {"w": np.arange(64.0) + comm.rank})
        bs = comm.state.extra["cr_buddy"]
        if comm.rank == 1:
            blob = bytearray(bs["self"][0])
            blob[-3] ^= 0xFF
            bs["self"][0] = bytes(blob)
        with pytest.raises(RuntimeError, match="CRC mismatch"):
            bdy.restore(comm)
        return True

    assert run_ranks(3, lambda c: fn(c, buddy)) == \
        ref_run_ranks(3, lambda c: fn(c, ref_buddy)) == [True] * 3


# ---- satellites ------------------------------------------------------

def test_victim_ranks_parsing():
    with knobs({"ft_inject_victim_rank": "0, 2,3"}):
        for fi in (ft_inject, ref_fi):
            assert fi.victim_ranks() == [0, 2, 3]
        with knobs({"ft_inject_plan": "rank_kill"}):
            for fi in (ft_inject, ref_fi):
                assert fi.rank_faults(2) == ["rank_kill"]
                assert fi.rank_faults(1) == []
                assert fi.rank_kill_victim() == 0


def test_victim_ranks_random_is_seed_deterministic():
    with knobs({"ft_inject_victim_rank": "random"}):
        for seed in ("0", "12345"):
            with knobs({"ft_inject_seed": seed}):
                a = ft_inject.victim_ranks(8)
                assert a == ft_inject.victim_ranks(8) == \
                    ref_fi.victim_ranks(8)
                assert 0 <= a[0] < 8


def test_cr_keep_mca_default(tmp_path):
    """cr_keep sets the job-wide default for checkpoint(..., keep=):
    the store is pruned to the newest N complete snapshots."""
    from ompi_tpu_torch import cr
    root = str(tmp_path / "store")
    with knobs({"cr_keep": "1"}):
        def fn(comm):
            for i in range(3):
                cr.checkpoint(comm, {"i": i}, store_dir=root)
            return True

        assert run_ranks(2, fn) == [True, True]
    done = [d for d in os.listdir(root)
            if os.path.isfile(os.path.join(root, d, "meta.json"))]
    assert len(done) == 1, sorted(os.listdir(root))


def test_purge_tickets_keeps_respawn_decisions():
    """Epoch rollover purges consumed agreement/shrink tickets but
    keeps the respawn decisions; finalize's purge_store drops every
    ULFM record — both packages on the same table."""
    for mod in (ulfm, ref_ulfm):
        world = SimpleNamespace(shared={}, shared_lock=threading.Lock())
        state = SimpleNamespace(rte=SimpleNamespace(world=world, kv=None))
        world.shared[("agree", 7, "d")] = True
        world.shared[("shrink", 3, "c", 0)] = [1]
        world.shared[("respawn", 1, "d")] = {"failed": [1]}
        world.shared[("ulfm", "cid")] = 4097
        world.shared[("other", "app")] = "untouched"
        mod.purge_tickets(state)
        assert ("agree", 7, "d") not in world.shared
        assert ("shrink", 3, "c", 0) not in world.shared
        assert ("respawn", 1, "d") in world.shared
        mod.purge_store(state)
        assert world.shared == {("other", "app"): "untouched"}, mod


@pytest.mark.parametrize("band", [0, 3])
def test_epoch_cid_banding(band):
    """After a recovery epoch, new cids come from the epoch's band
    inside the world's session band, so a replacement can never
    collide with a pre-failure cid — in band 0 (the reference's
    plain job) and band 3 (a resident session)."""
    def fn(comm):
        comm.state.respawn_epoch = 2
        sub = comm.dup()
        assert sub.cid >= respawn.epoch_cid_floor(band, 2)
        assert sub.cid < respawn.epoch_cid_floor(band, 3)
        return sub.cid

    cids = run_ranks(2, fn, cid_band=band)
    assert cids[0] == cids[1]
    assert cids[0] // SESSION_CID_STRIDE == band
    assert (cids[0] % SESSION_CID_STRIDE) // EPOCH_CID_STRIDE == 2
    if band == 0:
        assert cids == ref_run_ranks(2, fn)
    for e in (0, 1, 2, 1023, 1024):
        assert respawn.epoch_cid_floor(band, e) == \
            ref_respawn.epoch_cid_floor(band, e)


def test_rejoin_cid_stays_in_the_session_band(buddy_degree_1):
    """A recovery inside a world in session band 3 mints its rejoined
    communicator in band 3, epoch 1."""
    def fn(comm):
        if respawn.joining(comm.state):
            return respawn.rejoin(comm).cid
        try:
            buddy.checkpoint(comm, {"i": 0})
            if comm.rank == 1:
                ulfm.kill_now(comm.state)
            comm.Allreduce(np.ones(1), np.empty(1), port_op.SUM)
            return -1
        except eh.MPIException:
            return respawn.rejoin(comm).cid

    cids = run_ranks(3, fn, cid_band=3, respawn=True, timeout=60)
    assert len(set(cids)) == 1
    assert respawn.epoch_cid_floor(3, 1) <= cids[0] < \
        respawn.epoch_cid_floor(3, 2)


def test_ulfm_unfail_allows_re_kill_detection():
    """unfail() clears the delivery dedup: a rank that was replaced
    and later dies AGAIN is detected a second time (both packages)."""
    def fn(comm):
        u = comm.state.ulfm
        u.deliver(("fail", 1))
        assert u.poll() == 1 and 1 in u.failed
        u.unfail(1)
        assert 1 not in u.failed
        u.deliver(("fail", 1))
        assert u.poll() == 1
        return True

    assert run_ranks(1, fn) == ref_run_ranks(1, fn) == [True]


def test_ingest_filters_recovered_epochs():
    """Epoch-tagged failure records at or below the rank's recovery
    epoch are stale and must not re-kill a revived rank."""
    def fn(comm):
        u = comm.state.ulfm
        comm.state.respawn_epoch = 2
        u.deliver(("fail", 1, 1))
        u.deliver(("fail", 1, 2))
        assert u.poll() == 0 and 1 not in u.failed
        u.deliver(("fail", 1, 3))
        assert u.poll() == 1 and 1 in u.failed
        u.deliver(("fail", comm.rank, 3))  # own rank: alive
        assert u.poll() == 0
        return True

    assert run_ranks(1, fn) == ref_run_ranks(1, fn) == [True]


def test_epoch_rewire_resets_transports_and_pml():
    """``_epoch_rewire`` (the survivor's reset where transports must be
    rewired): the jobid and modex move to the epoch's namespace with a
    reset fence counter, btls whose ft_reset refuses the epoch are
    dropped, the pml is reset and re-wired, the modex re-published, two
    fences."""
    calls = []

    class Btl:
        def __init__(self, keep):
            self.keep = keep

        def ft_reset(self, epoch):
            calls.append(("btl", epoch, self.keep))
            return self.keep

    class Rte:
        jobid = "job-1"
        _fence_count = 3

        def modex_put(self, k, v):
            calls.append(("modex", k))

        def fence(self):
            calls.append(("fence",))

    class Pml:
        def ft_reset(self):
            calls.append(("pml_reset",))

        def add_procs(self, eps):
            calls.append(("add_procs", len(eps)))

    keep, drop, plain = Btl(True), Btl(False), object()
    state = SimpleNamespace(rte=Rte(), btls=[keep, drop, plain],
                            pml=Pml(), device=torch.device("cpu"),
                            rank=0, size=0, ft_epoch=0)
    respawn._epoch_rewire(state, 4)
    assert state.ft_epoch == 4 and state.btls == [keep, plain]
    rte = state.rte
    assert (rte.jobid, rte.jobid_base) == ("job-1:e4", "job-1")
    assert rte.modex_epoch == 4 and rte._fence_count == 0
    assert [c for c in calls if c[0] == "fence"] == [("fence",)] * 2
    assert ("pml_reset",) in calls and ("add_procs", 0) in calls
    assert {c[1] for c in calls if c[0] == "modex"} == {
        "device_id", "node_id", "cores"}
