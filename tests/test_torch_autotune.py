"""coll/autotune through the port (ompi_tpu_torch/coll/autotune and the
autotune window of coll/tuned.device_algorithm): the CPU cases of
tests/test_autotune.py, held against the reference.

Exact against the reference: the histogram helpers, and folds of the
same seeded dispatch/segment histograms from the same crafted profile
give the same ``seg_crossover_bytes``, ``hier_min_bytes``, EWMA state
and fusion flush threshold (``coll_device_fusion_max_ops``), fold after
fold.  Port only: the round trip — a skewed histogram moves the
crossover, the per-comm picks re-resolve at a collective-seq window
boundary through the put-once shared snapshot, the formerly single-
dispatch payload takes the segmented tier, byte-identical.
"""

import types

import numpy as np
import pytest
import torch

import ompi_tpu.coll.fusion  # noqa: F401  (registers the knobs below)
import ompi_tpu.coll.pipeline  # noqa: F401
from ompi_tpu import trace as ref_trace
from ompi_tpu.coll import autotune as ref_autotune
from ompi_tpu.coll import calibrate as ref_calibrate
from ompi_tpu.mca.params import registry as ref_registry
import ompi_tpu_torch.coll.fusion  # noqa: F401
from ompi_tpu_torch import trace
from ompi_tpu_torch.coll import autotune, calibrate, pipeline
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as mpi_op
from ompi_tpu_torch.testing import logical_devices, run_ranks

KNOBS = (
    "coll_autotune_enable", "coll_autotune_interval_ops",
    "coll_autotune_ewma", "coll_autotune_min_samples",
    "coll_autotune_window_ops", "coll_autotune_persist",
    "coll_autotune_fusion",
    "coll_tuned_use_measured_rules", "coll_tuned_profile_path",
    "coll_pipeline_enable", "coll_device_fusion_max_ops", "trace_enable",
)

PORT = (trace, autotune, calibrate, registry)
REF = (ref_trace, ref_autotune, ref_calibrate, ref_registry)


@pytest.fixture(autouse=True)
def _clean():
    saved = [(reg, {k: reg.get(k) for k in KNOBS})
             for reg in (registry, ref_registry)]
    yield
    for reg, vals in saved:
        for k, v in vals.items():
            reg.set(k, v)
    for mod in (autotune, ref_autotune):
        mod.reset()
    for mod in (calibrate, ref_calibrate):
        mod.reset_cache()


def _set(vals, pkgs=(PORT, REF)) -> None:
    for *_, reg in pkgs:
        for k, v in vals.items():
            reg.set(k, v)


def _seed_profile(pkg, path, **over):
    """Point a package at a crafted profile: crossovers parked at 1 GiB
    so nothing routes segmented until a fold moves them."""
    _, _, cal, reg = pkg
    reg.set("coll_tuned_profile_path", str(path))
    cal.reset_cache()
    prof = {
        "host": "test", "backend": "crafted", "source": "crafted",
        "host_alpha_us": 5.0, "host_gbs": 10.0, "dispatch_us": 200.0,
        "seg_bytes": 1 << 20,
        "seg_crossover_bytes": {"allreduce": 1 << 30, "bcast": 1 << 30,
                                "alltoall": 1 << 30},
        "hier_min_bytes": 1 << 30,
    }
    prof.update(over)
    cal.save_profile(prof, str(path))


def _fake_state(tr):
    """Registration target for unit-level folds: a tracer to read and
    no shared world (the fold skips the purge loop for it)."""
    return types.SimpleNamespace(
        tracer=tr, rte=types.SimpleNamespace(world=None), comms={})


# -- exact against the reference --------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_helpers_exact(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        hist = [int(v) for v in rng.integers(0, 40, trace.N_BUCKETS)
                * (rng.random(trace.N_BUCKETS) < 0.4)]
        for q in (0.1, 0.5, 0.9, 1.0):
            assert autotune._hist_quantile_us(hist, q) == \
                ref_autotune._hist_quantile_us(hist, q)
            assert autotune._hist_bucket_at(hist, q) == \
                ref_autotune._hist_bucket_at(hist, q)
        n = float(10 ** rng.uniform(3, 9))
        assert autotune._pow2_snap(n) == ref_autotune._pow2_snap(n)


def _fold_run(pkg, path, rounds, alpha):
    tr_mod, at_mod, cal, reg = pkg
    _seed_profile(pkg, path, host_alpha_us=alpha)
    tr = tr_mod.Tracer(0, capacity=64)
    tuner = at_mod.Autotuner()
    tuner.register(_fake_state(tr))
    out = []
    for disp, seg in rounds:
        for b, n in enumerate(disp):
            tr.hists[tr_mod.HIST_COLL_DISPATCH][b] += n
        for b, n in enumerate(seg):
            tr.hists[tr_mod.HIST_COLL_SEGMENT][b] += n
        moved = tuner.fold()
        prof = cal.get_profile(create=False)
        out.append((moved, prof["seg_crossover_bytes"],
                    prof["hier_min_bytes"], prof.get("autotune"),
                    tuner.dispatch_us, tuner.segment_us, tuner.fusion_ops,
                    int(reg.get("coll_device_fusion_max_ops"))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("ewma,fusion", [("1.0", "1"), ("0.25", "1"),
                                         ("0.5", "0")])
def test_fold_exact_against_reference(tmp_path, seed, ewma, fusion):
    """Folds of the same seeded histogram windows, from the same
    crafted profile, move the same thresholds as the reference's."""
    rng = np.random.default_rng(seed)
    _set({"coll_tuned_use_measured_rules": "1",
          "coll_autotune_min_samples": "16", "coll_autotune_ewma": ewma,
          "coll_autotune_fusion": fusion,
          "coll_device_fusion_max_ops": "32"})
    rounds = []
    for _ in range(5):
        disp = [0] * trace.N_BUCKETS
        seg = [0] * trace.N_BUCKETS
        for b in rng.integers(4, 16, int(rng.integers(4, 40))):
            disp[int(b)] += 1
        for b in rng.integers(2, 12, int(rng.integers(0, 40))):
            seg[int(b)] += 1
        rounds.append((disp, seg))
    alpha = float(rng.uniform(0.5, 50.0))
    got = _fold_run(PORT, tmp_path / "port.json", rounds, alpha)
    want = _fold_run(REF, tmp_path / "ref.json", rounds, alpha)
    assert got == want
    assert any(moved for moved, *_ in got)


# -- the round trip ---------------------------------------------------------

def test_fold_moves_crossover_and_repicks_byte_identical(tmp_path):
    """Skewed histograms (slow whole-op dispatch, fast per-segment
    meets) pull seg_crossover_bytes from 1 GiB down to 256 KiB =
    2 * seg_bytes * (seg_med/disp_med): the 640 KB allreduce that ran
    in one dispatch before the fold runs segmented after the window
    boundary, byte for byte the same."""
    _seed_profile(PORT, tmp_path / "prof.json")
    _set({"coll_tuned_use_measured_rules": "1",
          "coll_autotune_enable": "1",
          "coll_autotune_interval_ops": "1000000000",  # manual fold
          "coll_autotune_ewma": "1.0", "coll_autotune_min_samples": "8",
          "coll_autotune_window_ops": "4", "coll_autotune_fusion": "0",
          "coll_pipeline_enable": "1", "trace_enable": "1"}, (PORT,))
    autotune.reset()

    def fn(comm):
        x = (torch.arange(160000, dtype=torch.float32) % 11) + comm.rank
        ops0 = pipeline.pv_ops.read()
        pre = comm.allreduce_arr(x, mpi_op.SUM).numpy().tobytes()
        pre2 = comm.allreduce_arr(x, mpi_op.SUM).numpy().tobytes()
        ops_pre = pipeline.pv_ops.read() - ops0
        tr = comm.state.tracer
        assert tr is not None      # autotune implies a tracer
        tuner = autotune.active()
        assert tuner is not None
        if comm.rank == 0:
            # whole-op dispatch ~768 us (bucket 10), per-segment meet
            # ~96 us (bucket 7): ratio exactly 1/8
            tr.hists[trace.HIST_COLL_DISPATCH][10] += 200
            tr.hists[trace.HIST_COLL_SEGMENT][7] += 200
        comm.Barrier()
        if comm.rank == 0:
            assert tuner.fold() is True
        comm.Barrier()
        prof = calibrate.get_profile(create=False)
        assert prof["seg_crossover_bytes"]["allreduce"] == 262144
        # cross a window boundary so the purged picks re-resolve
        for _ in range(2 * tuner.window_ops()):
            comm.Barrier()
        ops1 = pipeline.pv_ops.read()
        post = comm.allreduce_arr(x, mpi_op.SUM).numpy().tobytes()
        ops_post = pipeline.pv_ops.read() - ops1
        # put-once snapshot: every re-ask in one window is one object
        win = comm._coll_seq // tuner.window_ops()
        tbl = tuner.thresholds_for(comm, win)
        assert tbl is not None and tuner.thresholds_for(comm, win) is tbl
        folds = registry._pvars["coll_autotune_folds"].read()
        cx = registry._pvars["coll_autotune_seg_crossover_allreduce"].read()
        assert folds == 1 and cx == 262144
        return pre, pre2, post, ops_pre, ops_post

    res = run_ranks(4, fn, device_map=logical_devices("cpu"))
    assert len({pre for pre, *_ in res}) == 1  # ranks agree
    for pre, pre2, post, ops_pre, ops_post in res:
        assert ops_pre == 0       # one dispatch while crossover sat high
        assert ops_post > 0       # segmented after the fold + window
        assert pre == pre2 == post  # the repick is invisible in bytes


# -- fold mechanics (no world) ----------------------------------------------

@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "reference"])
def test_fold_accumulates_below_min_samples(tmp_path, pkg):
    """An under-threshold window does not advance the histogram
    baselines; an immediate refold with nothing new is a no-op."""
    tr_mod, at_mod, cal, reg = pkg
    _seed_profile(pkg, tmp_path / "prof.json")
    _set({"coll_tuned_use_measured_rules": "1",
          "coll_autotune_min_samples": "32", "coll_autotune_ewma": "1.0",
          "coll_autotune_fusion": "0"}, (pkg,))
    tr = tr_mod.Tracer(0, capacity=64)
    tuner = at_mod.Autotuner()
    tuner.register(_fake_state(tr))
    tr.hists[tr_mod.HIST_COLL_DISPATCH][8] += 16
    assert tuner.fold() is False           # 16 < 32: accumulate
    assert tuner.folds == 0
    tr.hists[tr_mod.HIST_COLL_DISPATCH][8] += 16
    assert tuner.fold() is True            # both windows counted
    assert tuner.folds == 1
    assert cal.get_profile(create=False)["autotune"]["samples"] == 32
    assert tuner.fold() is False           # baselines advanced: no news


def test_fusion_retune_clamped(tmp_path):
    """The fusion flush threshold tracks dispatch_us/host_alpha_us but
    never escapes [4, 256]."""
    _seed_profile(PORT, tmp_path / "prof.json", host_alpha_us=0.5)
    _set({"coll_tuned_use_measured_rules": "1",
          "coll_autotune_min_samples": "1", "coll_autotune_ewma": "1.0",
          "coll_autotune_fusion": "1"}, (PORT,))
    tr = trace.Tracer(0, capacity=64)
    tuner = autotune.Autotuner()
    tuner.register(_fake_state(tr))
    tr.hists[trace.HIST_COLL_DISPATCH][15] += 10   # ~24.6 ms dispatch
    assert tuner.fold() is True
    assert int(registry.get("coll_device_fusion_max_ops")) == 256
    _seed_profile(PORT, tmp_path / "prof2.json", host_alpha_us=4000.0)
    tr2 = trace.Tracer(0, capacity=64)
    tuner2 = autotune.Autotuner()
    tuner2.register(_fake_state(tr2))
    tr2.hists[trace.HIST_COLL_DISPATCH][1] += 10   # ~1.5 us dispatch
    assert tuner2.fold() is True
    assert int(registry.get("coll_device_fusion_max_ops")) == 4


def test_autotune_off_costs_nothing():
    """coll_autotune_enable off (the default): no tuner, no tracer."""
    assert not autotune.enable_var.value

    def fn(comm):
        return comm.state.autotune, comm.state.tracer

    assert run_ranks(2, fn) == [(None, None), (None, None)]
    assert autotune.active() is None
