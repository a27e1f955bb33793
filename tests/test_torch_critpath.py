"""The critical-path profiler through the port (ompi_tpu_torch/tools/
critpath, the phase spans of coll/device, coll/pipeline and coll/plan):
the CPU cases of tests/test_critpath.py, held against the reference.

Exact against the reference: phase-category sampling, the label merge
of ``phase_totals``, the gating rule and clipped attribution on
synthetic spans, and ``critpath.analyze`` / ``report`` / the stitched
Chrome trace and traceview's merge of the same seeded synthetic dumps,
which must give equal dicts and equal JSON — the port reading its own
names where the reference's dumps carry ``ph_execute``: the port's
execute phase is the body's interval on the card, ``meet_device`` (cat
``meet``), from CUDA events, with no host fence.  Port only: a 4-rank
segmented-ring world, phase-profiled at full fidelity, attributes at
least 90 % of op wall time to named phases (the meeting's lock among
them) and, with an injected 40 ms straggler on one rank, names that
rank and the rendezvous as gating; the meeting's lock and wait spans
label as lock and rendezvous; on a card the deposit's ready event and
the output's collect are pack and unpack phases (steps the reference
has not); and the rendezvous wait no longer loses a wake-up that lands
during its progress sweep (the reference's does).
"""

import json
import threading

import numpy as np
import pytest
import torch

import ompi_tpu.coll.plan  # noqa: F401
from ompi_tpu import trace as ref_trace
from ompi_tpu.coll import device as ref_device
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.tools import critpath as ref_critpath
from ompi_tpu.tools import traceview as ref_traceview
import ompi_tpu_torch.coll.plan  # noqa: F401
from ompi_tpu_torch import trace
from ompi_tpu_torch.coll import device
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op.op import SUM
from ompi_tpu_torch.testing import run_ranks
from ompi_tpu_torch.tools import critpath, traceview

CPU = torch.device("cpu")

# segmented-ring pipeline knobs (the test_coll_pipeline PIPE_ON shape):
# small segments so a 16 KiB allreduce becomes several rendezvous; the
# plan tier collapses the per-segment phase structure to one meet
_PIPE_ON = {
    "coll_pipeline_enable": True,
    "coll_pipeline_min_bytes": 2048,
    "coll_seg_size": 4096,
    "coll_pipeline_rd_max_bytes": 0,
    "coll_plan_enable": False,
}


# every knob a test here sets, in either registry
_KNOBS = ("trace_enable", "trace_dump_path", "trace_phase_enable",
          "trace_sample_spec", "trace_sample_auto", "trace_sample_max",
          "ft_inject_plan", "ft_inject_skip", "ft_inject_delay_ms",
          *_PIPE_ON)


@pytest.fixture(autouse=True)
def _clean():
    """Restore every knob this file sets, in both registries, to the
    value it had: later test files in the process see the defaults."""
    saved = [(reg, {k: reg.get(k) for k in _KNOBS
                    if reg.get(k) is not None})
             for reg in (registry, ref_registry)]
    yield
    for reg, vals in saved:
        for k, v in vals.items():
            reg.set(k, v)


# -- sampling exactness for the phase category ------------------------------

@pytest.mark.parametrize("period", [1, 4, 5])
def test_phase_sampling_exact(period):
    """kept + sampled-out == seen for the phase category, the same
    spans kept as the reference keeps."""
    def run(mod):
        tr = mod.Tracer(0, capacity=4096)
        kept = []
        for i in range(100):
            t0 = tr.start_sampled(mod.CAT_PHASE)
            if t0:
                tr.end(t0, mod.NAME_PH_DISPATCH, mod.CAT_PHASE, 1, i, 0)
                kept.append(i)
        return (kept, tr.cat_seen("phase"), tr.dropped_by_cat()["phase"],
                tr.span_count("phase"), tr.sampling_rates()["phase"])

    for reg in (registry, ref_registry):
        reg.set("trace_sample_spec", f"phase:{period}")
        reg.set("trace_sample_auto", "0")
    got = run(trace)
    assert got == run(ref_trace)
    kept, seen, dropped, spans, rate = got
    assert len(kept) == -(-100 // period) == spans
    assert seen == 100 and dropped == 100 - spans and rate == period


def test_phase_totals_label_merge():
    """phase_totals folds span names into report labels (fused_pack
    and ph_pack are both 'pack'), as the reference's does, the port's
    meet_device (cat meet) where the reference's ph_execute is the
    execute phase; the port's kernel_load is the compile phase and its
    meet_lock the lock."""
    def run(mod, names):
        tr = mod.Tracer(0, capacity=64)
        tr.phase = True
        for name, cat in names:
            t0 = tr.start_sampled(mod.CAT_PHASE)
            tr.end(t0, mod._name_ids[name], mod._cat_ids[cat], 1, 0, 0)
        return set(tr.phase_totals())

    pack = (("ph_pack", "phase"), ("fused_pack", "phase"))
    assert run(trace, pack + (("meet_device", "meet"),)) == \
        run(ref_trace, pack + (("ph_execute", "phase"),)) == \
        {"pack", "execute"}
    assert run(trace, (("meet_lock", "meet"), ("meet_wait", "meet"))) == \
        {"lock", "rendezvous"}
    tr = trace.Tracer(0, capacity=8)
    t0 = tr.start()
    tr.end(t0, trace.NAME_KERNEL_LOAD, trace.CAT_COMPILE,
           trace.intern_name("stacked"))
    assert set(tr.phase_totals()) == {"compile"}


# -- the gating rule on synthetic spans -------------------------------------

def _sp(rank, ts, dur, name, cat, **args):
    return {"rank": rank, "ts": ts, "dur": dur, "name": name,
            "cat": cat, "ph": "X", "args": args}


# the execute phase's span as each package names it: the port's is the
# body's interval on the card from CUDA events, the reference's its
# host fence
_EXECUTE = {critpath: ("meet_device", "meet"),
            ref_critpath: ("ph_execute", "phase")}


@pytest.mark.parametrize("mod", [critpath, ref_critpath],
                         ids=["port", "reference"])
def test_gating_verdict_skew_vs_phase(mod):
    """A gate whose recorded phases are dwarfed by the arrival skew is
    arrival-gated ('rendezvous'); a gate with a contained phase at
    least as large as the skew is gated by THAT phase."""
    ex, cat = _EXECUTE[mod]
    events = [
        _sp(0, 0.0, 5100.0, "meet", "coll_dispatch", cid=1, seq=0),
        _sp(1, 5000.0, 100.0, "meet", "coll_dispatch", cid=1, seq=0),
        _sp(1, 5010.0, 40.0, ex, cat, cid=1, seq=0),
        _sp(0, 9000.0, 100.0, "meet", "coll_dispatch", cid=1, seq=1),
        _sp(1, 9010.0, 90.0, "meet", "coll_dispatch", cid=1, seq=1),
        _sp(1, 9012.0, 80.0, ex, cat, cid=1, seq=1),
    ]
    idx = mod.phase_index(events)
    groups = mod.group_ops(events)
    ga, skew_a = mod._gate_of(groups[("coll_dispatch", "meet", 1, 0)])
    gb, skew_b = mod._gate_of(groups[("coll_dispatch", "meet", 1, 1)])
    assert ga["rank"] == 1 and skew_a == 5000.0
    assert mod.gating_verdict(ga, skew_a, idx) == "rendezvous"
    assert gb["rank"] == 1 and skew_b == 10.0
    assert mod.gating_verdict(gb, skew_b, idx) == "execute"


@pytest.mark.parametrize("mod", [critpath, ref_critpath],
                         ids=["port", "reference"])
def test_clipped_attribution_never_exceeds_op(mod):
    ex, cat = _EXECUTE[mod]
    op = _sp(0, 100.0, 50.0, "meet", "coll_dispatch", cid=1, seq=0)
    phases = [
        _sp(0, 90.0, 40.0, "ph_dispatch", "phase", cid=1, seq=0),
        _sp(0, 120.0, 400.0, ex, cat, cid=1, seq=0),
    ]
    assert mod._clipped_phase_us(op, phases) <= op["dur"]


# -- exact against the reference on seeded synthetic dumps ------------------

_PHASES = ("ph_rdv_wait", "ph_pack", "ph_dispatch", "ph_execute",
           "ph_unpack")


def _synthetic_dumps(seed: int, nranks: int = 4, nops: int = 24):
    """Per-rank dumps of a seeded run: segmented ops (a pipeline_*
    dispatch span around seg_meet segments), single meets and plans,
    each member arriving with a seeded skew and one rank straggling
    now and then, phases inside each op window, p2p pairs sharing a
    match id, compile spans, instants and embedded clock offsets."""
    rng = np.random.default_rng(seed)
    t = 1.7e9 + seed
    ev = {r: [] for r in range(nranks)}

    def span(r, ts, dur, name, cat, **args):
        ev[r].append({"name": name, "cat": cat, "ph": "X", "ts": ts,
                      "dur": dur, "args": args})

    seq = 0
    for op in range(nops):
        kind = ("pipeline", "meet", "plan")[op % 3]
        late = int(rng.integers(0, nranks))
        starts = t + rng.uniform(0, 40e-6, nranks)
        starts[late] += rng.uniform(0, 3e-3) if op % 4 == 0 else 0.0
        nbytes = int(2 ** rng.integers(12, 24))
        for r in range(nranks):
            s0 = float(starts[r])
            end = float(max(starts)) + rng.uniform(50e-6, 400e-6)
            if kind == "pipeline":
                span(r, s0, end - s0, "pipeline_allreduce",
                     "coll_dispatch", cid=1, nbytes=nbytes,
                     alg=("segring", "segrd")[op % 2])
                nseg = 3
                for k in range(nseg):
                    a = s0 + (end - s0) * k / nseg
                    b = s0 + (end - s0) * (k + 1) / nseg
                    span(r, a, b - a, "seg_meet", "coll_segment", cid=1,
                         seq=seq + k, nbytes=nbytes // nseg)
                    cut = np.sort(rng.uniform(a, b, len(_PHASES) - 1))
                    bounds = [a, *cut, b]
                    for i, ph in enumerate(_PHASES):
                        span(r, float(bounds[i]),
                             float(bounds[i + 1] - bounds[i])
                             * rng.uniform(0.8, 1.0), ph, "phase",
                             cid=1, seq=seq + k, nbytes=nbytes)
            else:
                name, cat = (("meet", "coll_dispatch") if kind == "meet"
                             else ("plan_exec", "coll_segment"))
                args = dict(cid=1, seq=seq, nbytes=nbytes) \
                    if kind == "meet" else dict(cid=1, nbytes=nbytes,
                                                alg="hbm")
                span(r, s0, end - s0, name, cat, **args)
                rdv = float(max(starts)) - s0
                span(r, s0, rdv, "ph_rdv_wait", "phase", cid=1, seq=seq,
                     nbytes=nbytes)
                span(r, s0 + rdv, (end - s0 - rdv) * 0.4, "ph_dispatch",
                     "phase", cid=1, seq=seq, nbytes=nbytes)
                span(r, s0 + rdv + (end - s0 - rdv) * 0.4,
                     (end - s0 - rdv) * 0.5, "ph_execute", "phase",
                     cid=1, seq=seq, nbytes=nbytes)
            span(r, s0 - 30e-6, 25e-6, "allreduce", "coll", cid=1,
                 seq=op)
        seq += 3 if kind == "pipeline" else 1
        if op % 5 == 0:
            src, dst = op % nranks, (op + 1) % nranks
            mid = f"0:{src}:{op}:{op}"
            span(src, t, 30e-6, "send", "p2p", mid=mid, bytes=64)
            span(dst, t + 5e-6, 40e-6, "recv", "p2p", mid=mid, bytes=64)
        if op == 7:
            span(0, t, 1e-3, "xla_compile", "compile", key="plan")
            ev[2].append({"name": "ft_inject", "cat": "fault", "ph": "i",
                          "ts": t, "args": {"cls": "delay"}})
        t += 5e-3
    offsets = [round(float(o), 3) for o in rng.normal(0, 30, nranks)]
    offsets[0] = 0.0
    dumps = []
    for r in range(nranks):
        evs = sorted(ev[r], key=lambda e: e["ts"])
        d = {"rank": r, "recorded": len(evs), "dropped": 0,
             "capacity": 8192, "events": evs,
             "sampling": {"phase": 1}, "dropped_by_cat": {"phase": 0}}
        if seed % 2 == 0:
            d["mpisync"] = {"offsets_us": offsets}
        dumps.append(d)
    return dumps


def _port_dumps(dumps):
    """The same dumps as the port writes them: each ``ph_execute`` (the
    reference's host fence) is the port's ``meet_device``, cat meet."""
    out = json.loads(json.dumps(dumps))
    for d in out:
        for e in d["events"]:
            if e["name"] == "ph_execute":
                e["name"], e["cat"] = _EXECUTE[critpath]
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5])
@pytest.mark.parametrize("min_skew", [0.0, 1000.0])
def test_analyze_exact_on_synthetic_dumps(seed, min_skew):
    """The port's dumps give the reference's analysis document and
    report of the reference's dumps (execute read from meet_device),
    and the same dumps the same stitched Chrome trace and traceview
    summary."""
    dumps = _synthetic_dumps(seed)
    offsets = traceview.embedded_offsets(dumps)
    assert offsets == ref_traceview.embedded_offsets(dumps)
    got = critpath.analyze(_port_dumps(dumps), offsets,
                           min_skew_us=min_skew)
    want = ref_critpath.analyze(dumps, offsets, min_skew_us=min_skew)
    assert got == want
    assert got["coverage"] > 0 and got["multi_rank_ops"] > 0
    assert "execute" in got["phase_wall_us"]
    assert critpath.report(got) == ref_critpath.report(want)
    assert json.dumps(critpath.stitched_chrome_trace(dumps, offsets)) == \
        json.dumps(ref_critpath.stitched_chrome_trace(dumps, offsets))
    assert traceview.summary(dumps, offsets) == \
        ref_traceview.summary(dumps, offsets)


def test_cli_exact_on_synthetic_dumps(tmp_path, capsys):
    """The port's CLI prints, from the port's dump files, the JSON the
    reference's prints from its own, and both write the same stitched
    trace from the same files."""
    dumps = _synthetic_dumps(7)
    for name, ds in (("ref", dumps), ("port", _port_dumps(dumps))):
        (tmp_path / name).mkdir()
        for d in ds:
            (tmp_path / name / f"trace-r{d['rank']}.json").write_text(
                json.dumps(d))
    outs = []
    for mod, name in ((critpath, "port"), (ref_critpath, "ref")):
        assert mod.main([str(tmp_path / name / "trace-r*.json"),
                         "--json"]) == 0
        text = capsys.readouterr().out
        out = tmp_path / f"{name}.json"
        assert mod.main([str(tmp_path / "ref" / "trace-r*.json"), "-o",
                         str(out), "--json"]) == 0
        capsys.readouterr()
        outs.append((text, out.read_text()))
    assert outs[0] == outs[1]


def test_divergence_kernel_load_is_compile_phase():
    """A dump carrying the port's kernel_load span: the port's critpath
    attributes it to the compile phase; the reference's, which knows
    only xla_compile, leaves it out."""
    dumps = _synthetic_dumps(1)
    ev = dumps[0]["events"][0]
    dumps[0]["events"].append({"name": "kernel_load", "cat": "compile",
                               "ph": "X", "ts": ev["ts"], "dur": 2e-3,
                               "args": {"key": "stacked"}})
    got = critpath.analyze(dumps, [])
    want = ref_critpath.analyze(dumps, [])
    assert got["phase_wall_us"]["compile"] == pytest.approx(
        want["phase_wall_us"].get("compile", 0.0) + 2000.0, abs=0.2)


# -- the acceptance world: injected straggler named as gating ---------------

def _segring_world(tmp_path, victim=None):
    """One 4-rank segmented-ring world through the port (coll/hbm on
    the CPU), phase-profiled at full fidelity, dumped to tmp_path; when
    ``victim`` is set that rank straggles 40 ms at every rendezvous
    deposit (ft_inject)."""
    registry.set("trace_enable", "1")
    registry.set("trace_dump_path", str(tmp_path))
    registry.set("trace_phase_enable", "1")
    registry.set("trace_sample_auto", "0")   # full fidelity
    for k, v in _PIPE_ON.items():
        registry.set(k, v)
    if victim is not None:
        registry.set("ft_inject_plan", "delay:1.0")
        registry.set("ft_inject_skip", "0")
        registry.set("ft_inject_delay_ms", "40")

    def fn(comm):
        if victim is not None and comm.rank != victim:
            # disarm the injector cache: only the victim straggles
            comm.state.extra["coll_delay_inj"] = False
        x = torch.arange(4099, dtype=torch.float32) + comm.rank
        for _ in range(3):
            x = comm.allreduce_arr(x, SUM)
        comm.Barrier()
        return float(x[0])

    res = run_ranks(4, fn, device_map=lambda r: CPU, timeout=240)
    assert len(set(res)) == 1              # the collectives agreed
    dumps = traceview.load_dumps([str(tmp_path / "trace-r*.json")])
    assert len(dumps) == 4
    offsets = traceview.embedded_offsets(dumps)
    assert len(offsets) == 4               # auto-embedded at finalize
    return dumps, offsets


def test_phase_coverage_on_clean_segring(tmp_path):
    """On a clean 4-rank segmented-ring run, >= 90 % of op wall time is
    attributed to named phases, and the dispatch-tax table has
    per-phase medians for the segring tier."""
    dumps, offsets = _segring_world(tmp_path)
    doc = critpath.analyze(dumps, offsets)
    assert doc["coverage"] >= 0.90, doc
    assert doc["multi_rank_ops"] > 0
    assert any("segring" in k for k in doc["tax"]), doc["tax"]
    assert {"rendezvous", "lock", "pack", "dispatch", "unpack"} <= \
        set(doc["phase_wall_us"])
    # on the CPU no body runs on a card: no meet_device, no execute
    assert "execute" not in doc["phase_wall_us"]


def test_injected_delay_names_gating_rank(tmp_path):
    """A deterministic 40 ms ft_inject delay on ONE rank: the analysis
    names that rank as gating (arrival-gated: 'rendezvous'), the skew
    shows the stall, and the Chrome trace gets flow arrows."""
    victim = 2
    dumps, offsets = _segring_world(tmp_path, victim=victim)
    doc = critpath.analyze(dumps, offsets, min_skew_us=20000.0)
    gating = doc["gating"]
    assert gating, doc
    victim_gated = sum(v for k, v in gating.items()
                       if k.startswith(f"r{victim}:"))
    assert victim_gated > sum(gating.values()) / 2, gating
    assert next(iter(gating)) == f"r{victim}:rendezvous", gating
    assert doc["skew_us"]["max"] >= 20000.0, doc["skew_us"]
    # the injection left its instant on the victim's timeline
    assert any(e["name"] == "ft_inject" for e in dumps[victim]["events"])
    out = tmp_path / "stitched.json"
    rc = critpath.main([str(tmp_path / "trace-r*.json"),
                        "-o", str(out), "--json"])
    assert rc == 0
    stitched = json.loads(out.read_text())
    phs = {e.get("ph") for e in stitched["traceEvents"]}
    assert "s" in phs and "f" in phs       # perfetto flow arrows


# -- audit wiring -----------------------------------------------------------

def test_hotpath_audit_declares_phase_helpers():
    from ompi_tpu_torch.tools import hotpath_audit
    hot = hotpath_audit.HOT_FUNCTIONS
    for fn in ("_phase_fn", "_ph_rdv_start", "_ph_rdv_end"):
        assert fn in hot["ompi_tpu_torch/coll/device.py"]
    assert "_pull_segment" in hot["ompi_tpu_torch/coll/pipeline.py"]
    assert hotpath_audit.audit() == []


def _calls_with(fn_node, var: str):
    """The names of the functions ``fn_node`` calls with ``var`` among
    their arguments, and of every attribute it calls on ``var``'s
    items (``mk[0].end``)."""
    import ast
    out = set()
    for sub in ast.walk(fn_node):
        if not isinstance(sub, ast.Call):
            continue
        f = sub.func
        name = f.attr if isinstance(f, ast.Attribute) else \
            getattr(f, "id", None)
        if any(isinstance(a, ast.Name) and a.id == var for a in sub.args):
            out.add(name)
        if isinstance(f, ast.Attribute) and isinstance(
                f.value, ast.Subscript) and getattr(
                f.value.value, "id", None) == var:
            out.add(f"{var}[].{name}")
    return out


@pytest.mark.parametrize("qual, helpers", [
    ("Rendezvous.begin", {"_meet_lock", "_ph_rdv_start", "_meet_wait_end",
                          "_meet_post", "partial"}),
    ("Rendezvous.finish", {"_meet_lock", "_ph_rdv_start",
                           "_meet_wait_end"}),
    ("Rendezvous._work", {"_meet_post"}),
    ("_fence", {"_meet_device", "_marked_body"}),
])
def test_meeting_records_only_through_audited_helpers(qual, helpers):
    """The meeting's record sites in ``begin``, ``finish``, ``_work``
    and ``_fence`` record nothing themselves: the meet ctx goes only to
    helpers the audit holds to its rules (or through ``partial`` to
    ``_work``), and ``_fence`` marks the body's launches through one."""
    import ast
    import inspect
    from ompi_tpu_torch.tools import hotpath_audit
    hot = set(hotpath_audit.HOT_FUNCTIONS["ompi_tpu_torch/coll/device.py"])
    src = inspect.getsource(device)
    nodes = dict(hotpath_audit._iter_functions(ast.parse(src)))
    node = nodes[qual]
    got = _calls_with(node, "mk")
    if qual == "_fence":
        got |= {n for n in _calls_with(node, "body")
                if n == "_marked_body"}
    assert got == helpers
    assert got - {"partial"} <= hot
    assert not any(n.startswith("mk[]") for n in got)
    assert hotpath_audit.audit() == []


# -- the lost wake-up: repaired in the port, pinned in the reference --------

class _CountingCV:
    """The meeting's condvar with its timed waits counted; a wait
    returns at once as a timeout (no sleep), so the count is the number
    of 2 ms parks the waiter would have taken."""

    def __init__(self) -> None:
        self._cv = threading.Condition()
        self.waits = []

    def wait(self, timeout=None) -> bool:
        self.waits.append(timeout)
        return False

    def acquire(self, *a):
        return self._cv.acquire(*a)

    def release(self) -> None:
        self._cv.release()

    def notify_all(self) -> None:
        self._cv.notify_all()

    def __enter__(self):
        self._cv.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._cv.release()


class _SweepThatCompletes:
    """A progress engine whose sweep is where the last arriver completes
    the meeting: while the waiter has released the meeting lock, it
    takes the lock, sets the condition and notifies — the notify no
    waiter hears."""

    has_idle_fds = False

    def __init__(self, rv, flag) -> None:
        self.rv, self.flag = rv, flag

    def progress(self) -> int:
        with self.rv.cv:
            self.flag[0] = True
            self.rv.cv.notify_all()
        return 0

    def idle_wait(self, timeout) -> None:
        raise AssertionError("no idle fds")


@pytest.mark.parametrize("mod,parks", [(device, 1), (ref_device, 2)],
                         ids=["port", "reference"])
def test_lost_wakeup_during_progress_sweep(mod, parks):
    """The port re-reads cond() under the lock after its sweep and
    returns after the fast-path park alone; the reference parks a
    second time, for its full 2 ms timeout, on a meeting that is
    already complete (ompi_tpu/coll/device.py ``_wait_for``)."""
    rv = mod.Rendezvous(2)
    rv.cv = _CountingCV()
    flag = [False]
    with rv.cv:
        rv._wait_for(lambda: flag[0], "test", None,
                     _SweepThatCompletes(rv, flag))
    assert flag[0]
    assert rv.cv.waits == [0.002] * parks


# -- the port's deposit fence and output collect: a pinned divergence ------

class _CardTensor(torch.Tensor):
    """A CPU tensor that reports itself on a card, so the stream fence
    of a meeting runs on the CPU against stand-in events and streams."""

    @property
    def is_cuda(self):
        return True

    def record_stream(self, stream):
        stream.recorded.append(self)


class _Stream:
    def __init__(self) -> None:
        self.waited, self.recorded = [], []

    def wait_event(self, ev) -> None:
        self.waited.append(ev)


class _Event:
    def record(self, stream) -> None:
        self.stream = stream


def test_divergence_fence_and_collect_are_pack_and_unpack_phases(
        monkeypatch):
    """On a card the port records a deposit's ready event (``_fenced``)
    as a ``ph_pack`` and a member's wait on the meeting's done event
    (``_collect``) as a ``ph_unpack`` of the op; the reference has
    neither step (XLA orders its programs), and on the CPU, with no
    fence, neither span is recorded."""
    stream = _Stream()
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    x = torch.Tensor._make_subclass(_CardTensor, torch.zeros(4))
    tr = trace.Tracer(0, capacity=16)
    ph = (tr, 3, 7, 16)
    value, ev = device._fenced(x, ph)
    assert value is x and ev.stream is stream
    assert device._collect((x, ev), ph) is x
    assert stream.waited == [ev] and stream.recorded == [x]
    assert [(e["name"], e["args"]) for e in tr.snapshot()] == [
        ("ph_pack", {"cid": 3, "seq": 7, "nbytes": 16}),
        ("ph_unpack", {"cid": 3, "seq": 7, "nbytes": 16})]
    # sampled out (no ctx) and on the CPU (no fence): no span
    device._collect(device._fenced(x, None), None)
    cpu = torch.zeros(4)
    assert device._fenced(cpu, ph) == (cpu, None)
    assert device._collect((cpu, None), ph) is cpu
    assert len(tr.snapshot()) == 2


# -- the meeting's spans: lock, waits, the body on the card -----------------

class _TimedEvent:
    """A CUDA event stand-in that keeps its timing flag and counts the
    host's waits on it."""
    made = []

    def __init__(self, enable_timing: bool = False) -> None:
        self.timing, self.waits, self.stream = enable_timing, 0, None
        _TimedEvent.made.append(self)

    def record(self, stream) -> None:
        self.stream = stream
        stream.order.append(self)

    def synchronize(self) -> None:
        self.waits += 1

    def query(self) -> bool:
        return True

    def elapsed_time(self, other) -> float:
        return 0.5


class _OrderedStream(_Stream):
    cuda_stream = 77

    def __init__(self) -> None:
        super().__init__()
        self.order = []
        self.idle = False

    def query(self) -> bool:
        return self.idle

    def wait_event(self, ev) -> None:
        super().wait_event(ev)
        self.order.append(("wait", ev))


def test_fence_times_the_body_from_its_first_launch_without_a_wait(
        monkeypatch):
    """With a meet ctx the body's launches are marked: the card's first
    launch records a timing event just before it (after the stream's
    waits on the deposits and the body's host work), the done event
    times the body's end, and the pair is queued on the trigger's
    tracer, with the host ns of the start where the stream had nothing
    queued (a probe of the card's clock).  The host waits for the card
    once, for the card's anchor at its first traced body.  A later
    launch marks nothing more; an untraced body's launches mark nothing;
    a traced body that launched nothing on the card gets a plain done
    event and no span."""
    from ompi_tpu_torch.kernels import stacked
    stream = _OrderedStream()
    _TimedEvent.made = []
    monkeypatch.setattr(torch.cuda, "Event", _TimedEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: stream)
    monkeypatch.setattr(device, "_anchors", {})
    xs = [torch.Tensor._make_subclass(_CardTensor, torch.zeros(4))
          for _ in range(2)]
    ready = [_TimedEvent(), _TimedEvent()]
    slots = list(zip(xs, ready))
    tr = trace.Tracer(0, capacity=16)

    def body(values):
        stream.order.append("host work")
        for k in (1, 2):
            assert stacked.launch_stream(values[0].device) == 77
            stream.order.append(f"launch {k}")
        return list(values)

    for seq in (0, 1):
        del stream.order[:]
        stream.idle = seq == 0              # the first finds nothing queued
        outs = device._fence(body, (tr, 3, seq, 16))(slots)
        assert stream.order[:3] == [("wait", ready[0]), ("wait", ready[1]),
                                    "host work"]
        e0, done = stream.order[3], stream.order[6]
        assert stream.order[4:6] == ["launch 1", "launch 2"]
        assert e0.timing and done.timing and outs[0][1] is done
        # the first body's stream also records the card's anchor
        assert len(stream.order) == (8 if seq == 0 else 7)
        assert not stacked.marks.on
    (anchor,) = device._anchors.values()
    assert anchor.ev.waits == 1              # the one wait: the anchor
    assert sum(e.waits for e in _TimedEvent.made) == 1
    assert tr._dv_n == 2 and tr._dv_anchor[1] is anchor
    # the body that found its stream idle carries a probe of the clock
    assert tr._dv_idle[0] > 0 and tr._dv_idle[1] == 0
    spans = [e for e in tr.snapshot() if e["name"] == "meet_device"]
    # card 0: the stand-in tensors' device has no index
    assert [e["args"] for e in spans] == [
        {"cid": 3, "seq": 0, "card": 0}, {"cid": 3, "seq": 1, "card": 0}]
    # the anchor's host ns plus 0.5 ms each way (the stand-in's clock)
    assert all(e["dur"] == 0 and e["ts"] == tr._wall(anchor.ns + 500_000)
               for e in spans)
    assert len(anchor.ms) == 1 and anchor.a == anchor.b == 0
    n = len(_TimedEvent.made)
    outs = device._fence(body)(slots)
    assert len(_TimedEvent.made) == n + 1 and not outs[0][1].timing
    outs = device._fence(lambda values: list(values), (tr, 3, 2, 16))(slots)
    assert len(_TimedEvent.made) == n + 2 and not outs[0][1].timing
    assert tr._dv_n == 0 and tr.cursor == 2


def test_critpath_labels_the_meeting_spans():
    """critpath reads the meeting's spans as phases: ``meet_lock`` is
    the lock, ``meet_wait`` the rendezvous, ``meet_device`` the
    execute phase; a gate whose largest phase is its lock wait is
    gated by the lock, and ``meet_post`` is no phase."""
    events = [
        _sp(0, 0.0, 600.0, "meet", "coll_dispatch", cid=1, seq=0),
        _sp(1, 100.0, 500.0, "meet", "coll_dispatch", cid=1, seq=0),
        _sp(1, 100.0, 300.0, "meet_lock", "meet", cid=1, seq=0),
        _sp(1, 400.0, 50.0, "meet_wait", "meet", cid=1, seq=0),
        _sp(1, 450.0, 0.0, "meet_post", "meet", cid=1, seq=0),
        _sp(1, 460.0, 120.0, "meet_device", "meet", cid=1, seq=0),
    ]
    idx = critpath.phase_index(events)
    assert [critpath.PHASE_OF[e["name"]] for e in idx[1]] == [
        "lock", "rendezvous", "execute"]
    gate, skew = critpath._gate_of(
        critpath.group_ops(events)[("coll_dispatch", "meet", 1, 0)])
    assert gate["rank"] == 1 and skew == 100.0
    assert critpath.gating_verdict(gate, skew, idx) == "lock"
    assert trace.PHASE_LABELS["meet_lock"] == "lock"
    assert {k: v for k, v in trace.PHASE_LABELS.items()
            if k.startswith("meet_")} == {
        k: v for k, v in critpath.PHASE_OF.items() if k.startswith("meet_")}


def test_sampled_in_segments_record_the_meeting(tmp_path):
    """A segment of the pipelined tier that samples into the phase ctx
    records the meeting's spans against it: two locks a rank a segment,
    its waits as ph_rdv_wait alone, and one post a segment over the
    world (from the dispatcher thread); the critpath report carries
    the lock."""
    dumps, offsets = _segring_world(tmp_path)
    posts = 0
    for d in dumps:
        evs = d["events"]
        segs = sum(e["name"] == "seg_meet" for e in evs)
        # every meet (the Barriers' coll/sm meetings) times its lock too
        meets = sum(e["name"] == "meet" for e in evs)
        assert segs > 0
        assert sum(e["name"] == "meet_lock" for e in evs) == \
            2 * (segs + meets)
        assert sum(e["name"] == "meet_wait" for e in evs) == 0
        posts += sum(e["name"] == "meet_post" for e in evs)
    assert posts == sum(e["name"] in ("seg_meet", "meet")
                        for e in dumps[0]["events"])
    doc = critpath.analyze(dumps, offsets)
    assert doc["phase_wall_us"]["lock"] > 0
    assert "lock" in critpath.report(doc)
