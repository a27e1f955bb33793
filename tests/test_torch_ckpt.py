"""The tiered checkpoint engine through the port (ompi_tpu_torch/cr/ckpt:
the async collective-I/O filesystem tier under buddy, two-phase commit,
the CRC restore ladder, io fault injection, multi-kill chaos), with the
reference beside it.

The engine cases of tests/test_ckpt.py (its three shard cases are in
tests/test_torch_cr.py).  Every scenario runs through both packages
from the same seeded numpy inputs on ``run_ranks`` thread worlds: a
tensor leaf on the rank's device takes the jax leaf's place in the
port (a CPU tensor here, ``lambda r: torch.device("cpu")``, or one
logical device of the CPU a rank), numpy leaves stay numpy in both.
Results are compared by value and, where the reference's test reads
the store, the two stores' layouts are compared too.  Tolerance:
bytes — every value is a float sum of small integers, exact in any
order.

Two cases are the port's own, because a torch tensor is mutable where
a jax array is not: a tensor written in place right after
``checkpoint`` restores to its checkpointed bytes, and the drain tick
of a progress sweep never waits on a device-to-host copy (it takes a
shard only once its event has completed).  The first one's card
variant is in tests/test_torch_ckpt_card.py (no JAX there).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

import ompi_tpu.ft_inject  # noqa: F401  (registers the injector knobs)
from ompi_tpu import errhandler as ref_eh
from ompi_tpu.cr import buddy as ref_buddy
from ompi_tpu.cr import ckpt as ref_ckpt
from ompi_tpu.ft import respawn as ref_respawn
from ompi_tpu.ft import ulfm as ref_ulfm
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
import ompi_tpu_torch.ft_inject  # noqa: F401
from ompi_tpu_torch import errhandler as eh
from ompi_tpu_torch.cr import buddy, ckpt
from ompi_tpu_torch.cr import shard as shard_mod
from ompi_tpu_torch.ft import respawn, ulfm
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks
from ompi_tpu_torch.tools import hotpath_audit

SEED = 20261018
CPU = torch.device("cpu")
HBM = lambda r: CPU  # noqa: E731  (every rank on the CPU device)
FT = (eh.ERR_PROC_FAILED, eh.ERR_PROC_FAILED_PENDING, eh.ERR_REVOKED)


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


@pytest.fixture
def inject_now():
    """Arm ft_inject with no warm-up; the plan is always cleared."""
    with knobs({"ft_inject_skip": "0", "ft_inject_plan": ""}):
        yield


def _w(rank, i, n=256):
    rng = np.random.default_rng(SEED + 97 * rank + i)
    return rng.integers(-1000, 1000, n).astype(np.float64)


def _payload(port, rank, i):
    """The reference's payload with its array leaf as a tensor on the
    CPU in the port (numpy in the reference), plus a numpy leaf."""
    w = _w(rank, i)
    return {"i": i, "w": torch.from_numpy(w.copy()) if port else w,
            "m": np.arange(8, dtype=np.int32) * (rank + 1),
            "tag": f"r{rank}"}


def _vals(x):
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _check(out, rank, i, port):
    assert out["i"] == i and out["tag"] == f"r{rank}"
    if port:
        assert isinstance(out["w"], torch.Tensor)
    np.testing.assert_array_equal(_vals(out["w"]), _w(rank, i))
    np.testing.assert_array_equal(out["m"],
                                  np.arange(8, dtype=np.int32) * (rank + 1))


def _both(n, make, tmp_path, timeout=120, **kw):
    """``make(ck, port, store)``'s rank function on ``n`` ranks of each
    package (the port's on the CPU device), each with its own store;
    returns (reference results, port results, ref store, port store)."""
    rs, ps = str(tmp_path / "ref"), str(tmp_path / "port")
    ref = ref_run_ranks(n, make(ref_ckpt, False, rs), timeout=timeout, **kw)
    port = run_ranks(n, make(ckpt, True, ps), timeout=timeout,
                     device_map=HBM, **kw)
    return ref, port, rs, ps


# ---- filesystem tier roundtrips --------------------------------------

def test_fs_roundtrip_async(tmp_path):
    def make(ck, port, store):
        def fn(comm):
            ck.checkpoint(comm, _payload(port, comm.rank, 3),
                          store_dir=store)
            e = ck.flush(comm)
            out = ck.restore(comm, store_dir=store)
            _check(out, comm.rank, 3, port)
            return e
        return fn

    ref, port, rs, ps = _both(4, make, tmp_path)
    assert port == ref == [0] * 4
    for store in (rs, ps):
        man = json.load(open(os.path.join(store, "ep_000000",
                                          "manifest.json")))
        assert man["nprocs"] == 4 and len(man["ranks"]) == 4


def test_fs_roundtrip_sync_mode(tmp_path):
    def make(ck, port, store):
        def fn(comm):
            _, e = ck.checkpoint(comm, _payload(port, comm.rank, 5),
                                 store_dir=store)
            pend = ck.pending_epoch(comm.state)
            _check(ck.restore(comm, store_dir=store), comm.rank, 5, port)
            return (e, pend)
        return fn

    with knobs({"cr_drain_depth": "0"}):
        ref, port, _, _ = _both(4, make, tmp_path)
    assert port == ref == [(0, -1)] * 4


def test_fs_interval_and_deferred_commit(tmp_path):
    def make(ck, port, store):
        def fn(comm):
            epochs = [ck.checkpoint(comm, _payload(port, comm.rank, i),
                                    store_dir=store)[1] for i in range(4)]
            ck.flush(comm)
            return epochs
        return fn

    with knobs({"cr_fs_interval": "2"}):
        ref, port, rs, ps = _both(4, make, tmp_path)
    assert port == ref == [[0, -1, 1, -1]] * 4
    assert sorted(os.listdir(ps)) == sorted(os.listdir(rs)) == [
        "ep_000000", "ep_000001"]


def test_commit_record_published_put_once(tmp_path):
    def make(ck, port, store):
        ul = ulfm if port else ref_ulfm

        def fn(comm):
            ck.checkpoint(comm, _payload(port, comm.rank, 0),
                          store_dir=store)
            ck.flush(comm)
            return ul._store(comm.state).try_get(("cr_ckpt", "commit", 0))
        return fn

    ref, port, _, _ = _both(4, make, tmp_path)
    assert port == ref == [{"epoch": 0, "nprocs": 4}] * 4


def test_restore_ladder_empty_returns_none(tmp_path):
    def make(ck, port, store):
        return lambda comm: ck.restore(comm, store_dir=store)

    ref, port, _, _ = _both(2, make, tmp_path)
    assert port == ref == [None, None]


def test_shard_regions_match_the_reference(tmp_path):
    """The same numpy leaves checkpointed by both packages: every shard
    region of data.bin holds the same bytes under the same CRC (the
    residues differ — each pickles its own package's class paths)."""
    def make(ck, port, store):
        def fn(comm):
            ck.checkpoint(comm, {"a": _w(comm.rank, 1),
                                 "b": np.arange(5, dtype=np.int16)},
                          store_dir=store)
            ck.flush(comm)
            return True
        return fn

    _both(3, make, tmp_path)
    regions = []
    for store in (tmp_path / "ref", tmp_path / "port"):
        ep = store / "ep_000000"
        man = json.load(open(ep / "manifest.json"))
        data = (ep / "data.bin").read_bytes()
        regs = []
        for r in range(3):
            ent = man["ranks"][str(r)]
            for m in ent["shards"]:
                o = ent["off"] + m["off"]
                regs.append((r, m["idx"], m["crc"], m["nbytes"],
                             data[o:o + m["nbytes"]]))
        regions.append(regs)
    assert regions[0] == regions[1] and len(regions[1]) == 6


# ---- io fault injection ----------------------------------------------

def test_io_stall_delays_but_commits(tmp_path, inject_now):
    def make(ck, port, store):
        def fn(comm):
            ck.checkpoint(comm, _payload(port, comm.rank, 1),
                          store_dir=store)
            ck.flush(comm)
            _check(ck.restore(comm, store_dir=store), comm.rank, 1, port)
            return True
        return fn

    with knobs({"ft_inject_plan": "io_stall:1.0",
                "ft_inject_delay_ms": "5"}):
        ref, port, _, _ = _both(2, make, tmp_path)
    assert port == ref == [True] * 2


def test_io_partial_crc_falls_back_to_previous_epoch(tmp_path,
                                                     inject_now):
    fb0 = ckpt._pv_crc_fb.read()

    def make(ck, port, store):
        reg = registry if port else ref_registry

        def fn(comm):
            ck.checkpoint(comm, _payload(port, comm.rank, 0),
                          store_dir=store)
            ck.flush(comm)
            comm.Barrier()
            if comm.rank == 0:
                reg.set("ft_inject_plan", "io_partial:1.0")
            comm.Barrier()
            ck.checkpoint(comm, _payload(port, comm.rank, 1),
                          store_dir=store)
            ck.flush(comm)
            comm.Barrier()
            if comm.rank == 0:
                reg.set("ft_inject_plan", "")
            comm.Barrier()
            out = ck.restore(comm, store_dir=store)
            _check(out, comm.rank, 0, port)
            return out["i"]
        return fn

    ref, port, rs, ps = _both(4, make, tmp_path)
    assert port == ref == [0] * 4
    assert ckpt._pv_crc_fb.read() > fb0
    for store in (rs, ps):
        assert sorted(os.listdir(store)) == ["ep_000000", "ep_000001"]


def test_io_enospc_aborts_epoch_collectively(tmp_path, inject_now):
    ab0 = ckpt._pv_aborted.read()

    def make(ck, port, store):
        reg = registry if port else ref_registry

        def fn(comm):
            ck.checkpoint(comm, _payload(port, comm.rank, 0),
                          store_dir=store)
            ck.flush(comm)
            comm.Barrier()
            if comm.rank == 0:
                reg.set("ft_inject_plan", "io_enospc:1.0")
            comm.Barrier()
            ck.checkpoint(comm, _payload(port, comm.rank, 1),
                          store_dir=store)
            with pytest.raises(OSError, match="aborted"):
                ck.flush(comm)
            comm.Barrier()
            if comm.rank == 0:
                reg.set("ft_inject_plan", "")
            comm.Barrier()
            return ck.restore(comm, store_dir=store)["i"]
        return fn

    ref, port, rs, ps = _both(4, make, tmp_path)
    assert port == ref == [0] * 4
    assert ckpt._pv_aborted.read() > ab0
    for store in (rs, ps):
        assert not os.path.exists(os.path.join(store, "ep_000001",
                                               "manifest.json"))


def test_io_partial_sync_mode(tmp_path, inject_now):
    def make(ck, port, store):
        reg = registry if port else ref_registry

        def fn(comm):
            ck.checkpoint(comm, _payload(port, comm.rank, 0),
                          store_dir=store)
            comm.Barrier()
            if comm.rank == 0:
                reg.set("ft_inject_plan", "io_partial:1.0")
            comm.Barrier()
            ck.checkpoint(comm, _payload(port, comm.rank, 1),
                          store_dir=store)
            comm.Barrier()
            if comm.rank == 0:
                reg.set("ft_inject_plan", "")
            comm.Barrier()
            return ck.restore(comm, store_dir=store)["i"]
        return fn

    with knobs({"cr_drain_depth": "0"}):
        ref, port, _, _ = _both(2, make, tmp_path)
    assert port == ref == [0, 0]


# ---- the tentpole scenario: multi-kill chaos -------------------------

def _make_fn(ck, port, root, iters=8, kill_at=None):
    """App loop with per-iteration tiered checkpoints; kill_at maps
    rank -> iteration at which the ORIGINAL incarnation dies (several
    ranks at one iteration = one correlated multi-kill window).  The
    port's accumulator is a tensor on the rank's device."""
    rsp, ul, op, exc = ((respawn, ulfm, port_op, eh.MPIException) if port
                        else (ref_respawn, ref_ulfm, ref_op,
                              ref_eh.MPIException))
    kill_at = kill_at or {}

    def _step(i, acc, comm):
        x = np.full(4, (comm.rank + 1.0) * (i + 1))
        r = np.empty_like(x)
        comm.Allreduce(x, r, op.SUM)
        if port:
            return acc + torch.from_numpy(r).to(comm.state.device)
        return acc + r

    def fn(comm):
        state = comm.state
        was_joining = rsp.joining(state)
        recover = was_joining
        i = 0
        acc = (torch.zeros(4, dtype=torch.float64,
                           device=state.device) if port else np.zeros(4))
        did_kill = False
        while i < iters:
            try:
                if recover:
                    comm = rsp.rejoin(comm)
                    st = ck.restore(comm, store_dir=root)
                    i, acc = int(st["i"]), st["acc"]
                    recover = False
                ck.checkpoint(comm, {"i": i, "acc": acc}, store_dir=root)
                if (not was_joining and not did_kill
                        and kill_at.get(comm.rank) == i):
                    did_kill = True
                    ul.kill_now(state)
                acc = _step(i, acc, comm)
                i += 1
            except exc as e:
                if e.code not in FT:
                    raise
                if (not was_joining and not did_kill
                        and kill_at.get(comm.rank) == i):
                    did_kill = True
                    ul.kill_now(state)
                recover = True
        return _vals(acc).tobytes()
    return fn


def _chaos(tmp_path, n, kill_at):
    """Clean and killed runs of both packages: all four results must
    be equal.  Returns the port's restore pvars' moves in its killed
    run."""
    out = []
    for ck, port, runner, kw in (
            (ref_ckpt, False, ref_run_ranks, {}),
            (ckpt, True, run_ranks, {"device_map": HBM})):
        store = str(tmp_path / ("port" if port else "ref"))
        clean = runner(n, _make_fn(ck, port, store), timeout=120, **kw)
        shutil.rmtree(store, ignore_errors=True)
        fs0, bd0 = ckpt._pv_rest_fs.read(), ckpt._pv_rest_buddy.read()
        faulty = runner(n, _make_fn(ck, port, store, kill_at=kill_at),
                        timeout=180, respawn=True, **kw)
        assert faulty == clean
        out.append(clean)
    assert out[0] == out[1]
    return ckpt._pv_rest_fs.read() - fs0, ckpt._pv_rest_buddy.read() - bd0


def test_multikill_rank_and_buddy_falls_to_fs(tmp_path, buddy_degree_1):
    """8 ranks, degree 1: rank 1 AND its only partner (rank 2) die in
    one window; the ladder degrades to the filesystem tier and both
    packages finish byte-identical to a fault-free run."""
    fs, _ = _chaos(tmp_path, 8, {1: 5, 2: 5})
    assert fs > 0


def test_single_kill_stays_on_buddy_fast_path(tmp_path, buddy_degree_1):
    """One dead rank with a live partner: the buddy rung serves every
    restore, the filesystem tier is never read."""
    fs, bd = _chaos(tmp_path, 4, {1: 5})
    assert bd > 0 and fs == 0


def test_multikill_16_ranks_two_pairs(tmp_path, buddy_degree_1):
    """16 ranks, TWO correlated pairs dead in one window: one batched
    rejoin epoch, filesystem restores, byte-identical finish."""
    fs, _ = _chaos(tmp_path, 16, {1: 5, 2: 5, 9: 5, 10: 5})
    assert fs > 0


def test_large_state_async_roundtrip(tmp_path):
    """Multi-megabyte mixed tensor/numpy state through the async drain:
    many shards, several drain ticks, byte-exact restore."""
    def make(ck, port, store):
        def fn(comm):
            rng = np.random.default_rng(SEED + comm.rank)
            ws = [np.arange(65536.0) + comm.rank + k for k in range(8)]
            payload = {"w": [torch.from_numpy(w) if port else w
                             for w in ws],
                       "m": rng.normal(size=(512, 512))}
            ck.checkpoint(comm, payload, store_dir=store)
            ck.flush(comm)
            out = ck.restore(comm, store_dir=store)
            for a, b in zip(out["w"], ws):
                np.testing.assert_array_equal(_vals(a), b)
            np.testing.assert_array_equal(out["m"], payload["m"])
            return True
        return fn

    ref, port, _, _ = _both(4, make, tmp_path, timeout=240)
    assert port == ref == [True] * 4


# ---- retention + observability ---------------------------------------

def test_cr_keep_uniform_across_tiers(tmp_path):
    def make(ck, port, store):
        def fn(comm):
            for i in range(6):
                ck.checkpoint(comm, _payload(port, comm.rank, i),
                              store_dir=store)
            ck.flush(comm)
            return True
        return fn

    with knobs({"cr_keep": "3"}):
        assert buddy._keep_seqs() == ref_buddy._keep_seqs() == 3
        assert ckpt.keep_epochs() == ref_ckpt.keep_epochs() == 3
        _, _, rs, ps = _both(2, make, tmp_path)
    for store in (rs, ps):
        assert sorted(os.listdir(store)) == [
            "ep_000003", "ep_000004", "ep_000005"]
    with knobs({"cr_keep": "0"}):
        assert ckpt.keep_epochs() == ref_ckpt.keep_epochs() == 0
        assert buddy._keep_seqs() == buddy.KEEP_SEQS == ref_buddy.KEEP_SEQS
    with knobs({"cr_keep": "1"}):
        assert ckpt.keep_epochs() == ref_ckpt.keep_epochs() == 2
        assert buddy._keep_seqs() == buddy.KEEP_SEQS


def test_ckpt_pvars_count_work(tmp_path):
    pvs = (ckpt._pv_epochs, ckpt._pv_shards, ckpt._pv_bytes,
           ckpt._pv_ticks)
    base = [p.read() for p in pvs]

    def fn(comm):
        ckpt.checkpoint(comm, _payload(True, comm.rank, 0),
                        store_dir=str(tmp_path))
        # ticks drain what the epoch queued, then the flush commits
        for _ in range(50):
            if ckpt._engine(comm.state).pending.queue:
                comm.state.progress.progress()
        ckpt.flush(comm)
        return True

    assert run_ranks(2, fn, device_map=HBM) == [True] * 2
    for p, v in zip(pvs, base):
        assert p.read() > v, p.name
    assert ckpt._pv_stall.read() > 0


def test_hotpath_audit_stays_green():
    """Engine.tick is a declared hot function of the port too; the
    AST audit over every hot function stays empty."""
    assert "Engine.tick" in hotpath_audit.HOT_FUNCTIONS[
        "ompi_tpu_torch/cr/ckpt.py"]
    assert hotpath_audit.audit() == []


# ---- the port's own: snapshots of mutable tensors ---------------------

def _overwrite_fn(store, n_elems=4096):
    def fn(comm):
        dev = comm.state.device
        t = (torch.arange(n_elems, dtype=torch.float32, device=dev)
             * (comm.rank + 1))
        want = t.cpu().numpy().tobytes()
        ckpt.checkpoint(comm, {"t": t, "k": comm.rank}, store_dir=store)
        pend = ckpt.pending_epoch(comm.state)
        t.fill_(-1.0)  # in place, while the epoch's drain is pending
        ckpt.flush(comm)
        out = ckpt.restore(comm, store_dir=store)
        got = out["t"]
        return (pend, got.device == t.device,
                got.cpu().numpy().tobytes() == want, out["k"])
    return fn


@pytest.mark.parametrize("dm", ["cpu", "logical"])
def test_tensor_overwritten_after_checkpoint_restores_its_bytes(
        tmp_path, dm):
    """A tensor written in place right after ``checkpoint`` returned
    (its epoch still draining) restores to the bytes it held at the
    call: the drain reads the snapshot taken at plan, never the live
    tensor (the reference may hold its immutable jax leaf instead)."""
    device_map = HBM if dm == "cpu" else logical_devices("cpu")
    out = run_ranks(4, _overwrite_fn(str(tmp_path)), device_map=device_map)
    assert out == [(0, True, True, r) for r in range(4)]


class _SlowCopy:
    """A device-to-host copy's event stand-in: not complete until
    released; counts its waits."""

    waits = 0

    def __init__(self) -> None:
        self.done = False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        _SlowCopy.waits += 1
        self.done = True


def test_drain_tick_never_blocks_on_an_event(tmp_path, monkeypatch):
    """The engine's progress tick takes a tensor shard only once its
    copy's event has completed and never waits on one: with the copies
    still in flight, ticks and whole progress sweeps write nothing and
    wait on nothing; once the events complete, one tick drains them
    without a wait; flush then commits and the epoch restores."""
    real = shard_mod.snapshot

    def slow_snapshot(t):
        stage, _ = real(t)
        return stage, _SlowCopy()

    monkeypatch.setattr(shard_mod, "snapshot", slow_snapshot)
    _SlowCopy.waits = 0

    def fn(comm):
        payload = {"a": torch.arange(64.0) + comm.rank,
                   "b": torch.ones(32, dtype=torch.int64) * comm.rank}
        ckpt.checkpoint(comm, payload, store_dir=str(tmp_path))
        eng = ckpt._engine(comm.state)
        evs = [sh.event for sh, _ in eng.pending.queue]
        for _ in range(20):
            assert eng.tick() == 0
            comm.state.progress.progress()
        stuck = len(eng.pending.queue)
        for ev in evs:
            ev.done = True  # the copies land
        drained = eng.tick()
        comm.Barrier()
        waits = _SlowCopy.waits
        ckpt.flush(comm)
        out = ckpt.restore(comm, store_dir=str(tmp_path))
        return (len(evs), stuck, drained, waits,
                _vals(out["a"]).tolist()[:2], int(out["b"][0]))

    out = run_ranks(2, fn, device_map=HBM)
    assert out == [(2, 2, 2, 0, [0.0, 1.0], 0),
                   (2, 2, 2, 0, [1.0, 2.0], 1)]


def test_flush_waits_for_copies_in_flight(tmp_path, monkeypatch):
    """``flush`` (the commit) may wait: an epoch whose copies are still
    in flight commits, waiting once a shard, and restores its bytes."""
    real = shard_mod.snapshot

    def slow_snapshot(t):
        stage, _ = real(t)
        return stage, _SlowCopy()

    monkeypatch.setattr(shard_mod, "snapshot", slow_snapshot)
    _SlowCopy.waits = 0

    def fn(comm):
        ckpt.checkpoint(comm, {"a": torch.arange(16.0) * (comm.rank + 2)},
                        store_dir=str(tmp_path))
        e = ckpt.flush(comm)
        out = ckpt.restore(comm, store_dir=str(tmp_path))
        return (e, _vals(out["a"]).tolist())

    out = run_ranks(2, fn, device_map=HBM)
    assert out == [(0, [2.0 * k for k in range(16)]),
                   (0, [3.0 * k for k in range(16)])]
    assert _SlowCopy.waits == 2
