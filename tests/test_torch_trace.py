"""The span tracer (ompi_tpu_torch/trace, peruse, tools/traceview,
tools/hotpath_audit) held against the reference's (ompi_tpu/trace):
the CPU cases of tests/test_trace.py through the port.

Exact against the reference, on the same seeded numpy inputs: the
log2 bucket functions and the histograms they feed, the sampling
counters (kept + sampled out == seen, the adaptive backoff), ring
wraparound and its drop accounting, the decoded span args, and
traceview's merge of the same dumps.  Structural: a 4-rank traced
world through both packages (host p2p, blocking collectives, an nbc
and a segmented-ring allreduce_arr with the phase profiler armed)
gives, per rank, the same multiset of (cat, name) spans, the same
(cid, seq) correlation keys and the same ob1 match ids.  Port only:
the cost contract (tracing off is one is-None check everywhere; the
recording hot path retains nothing; the wall clock is read once), the
pvar and dump surfaces, the traceview CLI, the extended PERUSE events
and the hot-path audit.

The pml/monitoring dump cases of tests/test_trace.py (two of its last
three tests) are tests/test_torch_monitoring.py's; its pstat case is
``test_pstat_pvars_idempotent_across_worlds`` here.
"""

import gc
import json
import os
import time
import tracemalloc
from collections import Counter

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.plan  # noqa: F401  (registers the plan knobs)
from ompi_tpu import peruse as ref_peruse
from ompi_tpu import trace as ref_trace
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu.tools import traceview as ref_traceview
import ompi_tpu_torch.coll.plan  # noqa: F401
from ompi_tpu_torch import peruse, trace
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks
from ompi_tpu_torch.tools import traceview

CPU = torch.device("cpu")
SEEDS = (0, 1, 2, 3)

# the segring shape of tests/test_critpath.py: small segments so a
# 16 KiB allreduce_arr becomes several rendezvous
_PIPE_ON = {"coll_pipeline_enable": True, "coll_pipeline_min_bytes": 2048,
            "coll_seg_size": 4096, "coll_pipeline_rd_max_bytes": 0,
            "coll_hier_enable": False, "coll_plan_enable": False}
# every knob a test here sets, in either registry
_KNOBS = ("trace_enable", "trace_dump_path", "trace_buffer_events",
          "trace_sample_spec", "trace_sample_auto", "trace_sample_max",
          "trace_phase_enable", "coll_sm_priority", *_PIPE_ON)


def _both(knobs) -> None:
    for reg in (ref_registry, registry):
        for k, v in knobs.items():
            reg.set(k, v)


@pytest.fixture(autouse=True)
def _clean_trace():
    """Restore every knob this file sets, in both registries, to the
    value it had: later test files in the process see the defaults."""
    saved = [(reg, {k: reg.get(k) for k in _KNOBS
                    if reg.get(k) is not None})
             for reg in (ref_registry, registry)]
    yield
    for reg, vals in saved:
        for k, v in vals.items():
            reg.set(k, v)
    peruse.unsubscribe_all()
    ref_peruse.unsubscribe_all()


def _traffic(comm, op):
    """A little of everything: p2p, blocking colls, an nbc."""
    sbuf = np.ones(4, np.float32) * (comm.rank + 1)
    rbuf = np.zeros(4, np.float32)
    nxt = (comm.rank + 1) % comm.size
    prv = (comm.rank - 1) % comm.size
    rq = comm.Irecv(rbuf, prv, tag=3)
    comm.Send(sbuf, nxt, tag=3)
    rq.wait()
    comm.Allreduce(sbuf, rbuf, op.SUM)
    comm.Barrier()
    r = comm.Ibarrier()
    r.wait()


def _port_traffic(comm):
    _traffic(comm, port_op)


def _durations(seed: int, n: int = 400) -> np.ndarray:
    """Seconds, log-uniform from 0.1 us to an hour, plus exact zeros
    and bucket edges."""
    rng = np.random.default_rng(seed)
    d = 10.0 ** rng.uniform(-7, 3.6, n)
    edges = np.array([0.0, 1e-6, 2e-6, 3e-6, 1024e-6, 2 ** 19 * 1e-6])
    return np.concatenate([d, edges])


# -- exact against the reference: buckets, histograms -----------------------

def test_bucket_tables_match_reference():
    assert trace.N_BUCKETS == ref_trace.N_BUCKETS
    assert trace.BUCKET_BOUNDS_US == ref_trace.BUCKET_BOUNDS_US
    assert trace.HIST_NAMES == ref_trace.HIST_NAMES
    assert trace.SPAN_CATS == ref_trace.SPAN_CATS
    assert [trace.bucket_upper_us(b) for b in range(trace.N_BUCKETS)] == \
        [ref_trace.bucket_upper_us(b) for b in range(trace.N_BUCKETS)]
    # the names interned at import keep the reference's ids; the
    # port's own compile span comes after them
    n = trace.NAME_KERNEL_LOAD
    assert trace._names[:n] == ref_trace._names[:n]
    assert trace._cats[:len(ref_trace._cats)] == ref_trace._cats


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["hist_add", "tick_ns"])
def test_histograms_exact(seed, which):
    """The same seeded durations land in the same log2 buckets."""
    got = trace.Tracer(0, capacity=8)
    want = ref_trace.Tracer(0, capacity=8)
    for d in _durations(seed):
        for tr in (got, want):
            if which == "hist_add":
                tr.hist_add(trace.HIST_COLL_DISPATCH, float(d))
            else:
                tr.tick_ns(int(d * 1e9))
    assert got.hists == want.hists
    h = trace.HIST_COLL_DISPATCH if which == "hist_add" \
        else trace.HIST_PROGRESS_TICK
    assert got.hist_total(h) == len(_durations(seed))


# -- exact against the reference: sampling ----------------------------------

def _sample(mod, cat_name: str, name: str, nspans: int) -> dict:
    tr = mod.Tracer(0, capacity=4096)
    cat = mod._cat_ids[cat_name]
    nid = mod._name_ids[name]
    kept = []
    for i in range(nspans):
        t0 = tr.start_sampled(cat)
        if t0:
            tr.end(t0, nid, cat, 1, i, 2, 3, 8)
            kept.append(i)
    return {"kept": kept, "recorded": tr.recorded, "dropped": tr.dropped,
            "seen": tr.cat_seen(cat_name),
            "dropped_by_cat": tr.dropped_by_cat(),
            "rates": tr.sampling_rates(),
            "spans": tr.span_count(cat_name),
            # bucket contents are durations; their totals are counts
            "hist_totals": [sum(h) for h in tr.hists]}


@pytest.mark.parametrize("cat,name", [("p2p", "send"), ("coll", "meet"),
                                      ("coll_dispatch", "meet"),
                                      ("phase", "ph_dispatch"),
                                      ("rma", "rma_put")])
@pytest.mark.parametrize("period", [1, 4, 7])
def test_sampled_counters_exact(cat, name, period):
    """1-in-N sampling never loses count: kept + sampled-out equals
    seen, the same spans are kept as the reference keeps, and the
    pvar-facing accessors agree."""
    _both({"trace_sample_spec": f"{cat}:{period}",
           "trace_sample_auto": "0"})
    got = _sample(trace, cat, name, 100)
    assert got == _sample(ref_trace, cat, name, 100)
    assert len(got["kept"]) == -(-100 // period)
    assert got["recorded"] == 100 == got["seen"]
    assert got["spans"] + got["dropped_by_cat"][cat] == got["seen"]
    assert got["rates"][cat] == period


@pytest.mark.parametrize("auto,cap", [(8, 16), (4, 64), (32, 4), (0, 64)])
def test_adaptive_sampling_exact(auto, cap):
    """The period doubles every trace_sample_auto SEEN events up to
    trace_sample_max, exactly as the reference's does; quiet
    categories never leave full fidelity."""
    _both({"trace_sample_auto": str(auto), "trace_sample_max": str(cap)})
    got = _sample(trace, "coll", "meet", 200)
    assert got == _sample(ref_trace, "coll", "meet", 200)
    assert got["rates"]["p2p"] == 1
    assert got["seen"] == 200
    assert got["spans"] + got["dropped_by_cat"]["coll"] == 200


@pytest.mark.parametrize("seed", SEEDS)
def test_gate_sampled_exact(seed):
    """gate_sampled (the per-op phase ctx gate) keeps the same ops as
    the reference's under a seeded mix of gates and spans."""
    _both({"trace_sample_auto": "6", "trace_sample_max": "8"})
    rng = np.random.default_rng(seed)
    kinds = rng.integers(0, 2, 300)

    def run(mod):
        tr = mod.Tracer(0, capacity=64)
        out = []
        for k in kinds:
            if k:
                out.append(tr.gate_sampled(mod.CAT_PHASE))
            else:
                t0 = tr.start_sampled(mod.CAT_PHASE)
                if t0:
                    tr.end(t0, mod.NAME_PH_PACK, mod.CAT_PHASE, 1, 0, 0)
                out.append(bool(t0))
        return out, tr.cat_seen("phase"), tr.dropped_by_cat()["phase"], \
            tr.sampling_rates()["phase"]

    assert run(trace) == run(ref_trace)


# -- exact against the reference: the ring ----------------------------------

@pytest.mark.parametrize("capacity", [1, 8, 13])
def test_ring_wraparound_exact(capacity):
    """Overwrite accounting is exact and oldest-first unrolling keeps
    the newest events, as in the reference."""
    def run(mod):
        tr = mod.Tracer(0, capacity=capacity)
        for i in range(20):
            tr.instant(f"ev{i}", "test", i=i)
            t0 = tr.start()
            tr.end(t0, mod.NAME_MEET, mod.CAT_COLL_DISPATCH, 1, i, 64)
        kept = [(e["name"], e["cat"], e["ph"], e["args"])
                for e in tr.snapshot()]
        return kept, tr.recorded, tr.dropped, tr.dropped_by_cat()

    got = run(trace)
    assert got == run(ref_trace)
    kept, recorded, dropped, _ = got
    assert len(kept) == capacity
    assert recorded == 40 and dropped == 40 - capacity


def test_span_args_decode_exact():
    """Every span name the two packages share decodes its integer arg
    columns into the same args dict (the p2p match id synthesized at
    snapshot time, 'key$' fields as interned names).  The shared names
    are every name the reference's trace module interns as a NAME_
    constant (each must be in the port's table) and any name both
    tables have interned since — the reference interns a collective's
    name when it first traces one, so its table depends on which tests
    ran before in the process."""
    static = {ref_trace._names[getattr(ref_trace, a)]
              for a in dir(ref_trace) if a.startswith("NAME_")}
    assert static <= set(trace._name_ids)
    shared = [n for n in ref_trace._names if n in trace._name_ids]

    def run(mod):
        # room for every span: a ring that wrapped would drop the first
        tr = mod.Tracer(0, capacity=len(shared) + 64)
        alg = mod.NAME_PH_PACK  # an id both tables hold at one index
        for name in shared:
            t0 = tr.start()
            tr.end(t0, mod._name_ids[name], mod.CAT_P2P
                   if name in ("send", "recv") else mod.CAT_COLL,
                   3, 5, alg, 7, 9)
        t0 = tr.start()
        tr.end_slow(t0, "reconnect", "oob", node="n0")
        return [(e["name"], e["cat"], e["args"]) for e in tr.snapshot()]

    got = run(trace)
    assert got == run(ref_trace)
    assert got[0][2] == {"mid": f"3:5:{trace.NAME_PH_PACK}:7", "bytes": 9}
    assert got[-1][2] == {"node": "n0"}


# -- port only: the cost contract -------------------------------------------

def test_trace_disabled_costs_nothing():
    """trace_enable off (default): every layer's cached tracer slot is
    None — the single-attribute-check contract."""
    assert not trace.enable_var.value

    def fn(comm):
        assert comm.state.tracer is None
        assert comm.state.progress.tracer is None
        assert comm.state.pml._tracer is None
        assert trace.current_tracer() is None
        _port_traffic(comm)
        return comm.state.tracer is None

    assert all(run_ranks(2, fn))
    assert trace.global_tracer() is None


def test_enabled_hot_path_retains_no_objects():
    """The recording hot path allocates nothing that survives the call
    (tracemalloc over thousands of start_sampled/end pairs: skip
    branch, keep branch, adaptation and wraparound exercised)."""
    tr = trace.Tracer(0, capacity=256)
    for _ in range(2048):
        t0 = tr.start_sampled(trace.CAT_COLL_DISPATCH)
        if t0:
            tr.end(t0, trace.NAME_MEET, trace.CAT_COLL_DISPATCH, 1, 2, 3)
    gc.collect()
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    for _ in range(4000):
        t0 = tr.start_sampled(trace.CAT_COLL_DISPATCH)
        if t0:
            tr.end(t0, trace.NAME_MEET, trace.CAT_COLL_DISPATCH, 1, 2, 3)
    gc.collect()
    grown = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown < 4096, f"hot path retained {grown} bytes over 4000 spans"


def test_wall_anchor_read_once():
    """time.time is read ONCE at Tracer construction; recording and
    snapshot decoding run on perf_counter_ns and the stored anchor."""
    tr = trace.Tracer(0, capacity=8)
    real_time = time.time

    def boom():
        raise AssertionError("wall clock read on the hot path")

    time.time = boom
    try:
        t0 = tr.start()
        tr.end(t0, trace.NAME_MEET, trace.CAT_COLL, 7, 1, 64)
        t1 = tr.start_sampled(trace.CAT_COLL)
        tr.end(t1, trace.NAME_MEET, trace.CAT_COLL, 7, 2, 64)
        evs = tr.snapshot()
    finally:
        time.time = real_time
    assert len(evs) == 2
    assert evs[0]["ts"] <= evs[1]["ts"]
    assert abs(evs[0]["ts"] - tr.anchor_wall) < 5.0


# -- port only: pvars, dumps, histograms ------------------------------------

def _pvar(name):
    return registry._pvars[name].read()


def test_sampling_pvars_and_dump_sections(tmp_path):
    """The sampling/drop accounting is visible in the pvars, the dump's
    sampling / dropped_by_cat / anchor / mpisync sections, and the
    traceview summary."""
    registry.set("trace_enable", "1")
    registry.set("trace_dump_path", str(tmp_path))
    registry.set("trace_sample_spec", "coll:8")

    def fn(comm):
        for _ in range(32):
            comm.Barrier()
        tr = comm.state.tracer
        rates = _pvar("trace_sampling_rate")
        dropped = _pvar("trace_dropped_coll")
        assert rates["coll"] == 8
        assert dropped > 0
        assert dropped == tr.dropped_by_cat()["coll"]
        assert tr.span_count("coll") + dropped == tr.cat_seen("coll")
        return True

    assert all(run_ranks(2, fn))
    doc = json.loads((tmp_path / "trace-r0.json").read_text())
    assert doc["sampling"]["coll"] == 8
    assert doc["dropped_by_cat"]["coll"] > 0
    assert doc["anchor"]["wall_s"] > 0 and doc["anchor"]["perf_ns"] > 0
    # the finalize-time mpisync table rides every dump, even in a
    # thread world whose ranks share one clock
    assert len(doc["mpisync"]["offsets_us"]) == 2
    dumps = traceview.load_dumps([str(tmp_path / "*.json")])
    text = traceview.summary(dumps, [0.0, 0.0])
    assert "dropped by category" in text
    assert "sampling 1-in-N" in text and "coll:8" in text


def test_histogram_pvars_match_span_counts():
    registry.set("trace_enable", "1")
    registry.set("trace_buffer_events", "65536")

    def fn(comm):
        _port_traffic(comm)
        _port_traffic(comm)
        tr = comm.state.tracer
        assert tr.dropped == 0
        assert tr.hist_total(trace.HIST_P2P_COMPLETE) == \
            tr.span_count("p2p")
        assert tr.hist_total(trace.HIST_COLL_DISPATCH) == \
            tr.span_count("coll_dispatch")
        assert sum(_pvar("trace_hist_p2p_complete")) == \
            tr.span_count("p2p")
        assert _pvar("trace_events_recorded") == tr.recorded
        # sweep latency is sampled 1-in-16: enough explicit sweeps
        # guarantee at least one lands on the timed stride
        for _ in range(33):
            comm.state.progress.progress()
        assert tr.hist_total(trace.HIST_PROGRESS_TICK) > 0
        return True

    assert all(run_ranks(2, fn))


# -- structural parity: a 4-rank traced world through both packages --------

_STRUCT_CATS = ("p2p", "coll", "nbc", "phase", "coll_dispatch",
                "coll_segment")
# phases recorded on the triggering rank's tracer: which rank triggers
# a meeting depends on arrival order, so they compare as world totals
_TRIGGER_PHASES = ("ph_dispatch", "ph_execute")


def _world(run, put, op, device_map, tmp_path):
    """The traced 4-rank world; both packages' thread worlds route
    host-buffer collectives through coll/sm (a rendezvous)."""
    def fn(comm):
        _traffic(comm, op)
        x = put(np.arange(4099, dtype=np.float32) + comm.rank, comm)
        for _ in range(2):
            x = comm.allreduce_arr(x, op.SUM)
        comm.Barrier()
        return comm.state.tracer.snapshot(), np.asarray(x).tobytes()

    tmp_path.mkdir()

    _both({"trace_enable": "1", "trace_phase_enable": "1",
           "trace_sample_auto": "0", "trace_buffer_events": "65536",
           "trace_dump_path": str(tmp_path)})
    _both(_PIPE_ON)
    return run(4, fn, device_map=device_map, timeout=240)


def _structure(events):
    per = Counter((e["cat"], e["name"]) for e in events
                  if e["ph"] == "X" and e["cat"] in _STRUCT_CATS
                  and e["name"] not in _TRIGGER_PHASES)
    trig = Counter(e["name"] for e in events
                   if e["name"] in _TRIGGER_PHASES)
    keys = sorted((e["cat"], e["name"], e["args"]["cid"], e["args"]["seq"])
                  for e in events if e["ph"] == "X"
                  and e["cat"] in ("coll", "nbc", "coll_dispatch",
                                   "coll_segment")
                  and "seq" in e["args"])
    mids = sorted((e["name"], e["args"]["mid"]) for e in events
                  if e["cat"] == "p2p")
    return per, trig, keys, mids


def test_traced_world_structural_parity(tmp_path):
    """Per rank, the port records the reference's spans: the same
    multiset of (cat, name) over p2p, coll, nbc, dispatch, segment and
    phase spans, the same (cid, seq) keys, the same ob1 match ids; the
    triggering rank's dispatch/execute phases match as world totals.
    The results are the same bytes."""
    ref = _world(ref_run_ranks, lambda a, c: jax.device_put(a, c.device),
                 ref_op, lambda r: jax.devices()[0], tmp_path / "ref")
    port = _world(run_ranks, lambda a, c: torch.from_numpy(a), port_op,
                  lambda r: CPU, tmp_path / "port")
    assert [b for _, b in port] == [b for _, b in ref]
    trig_ref, trig_port = Counter(), Counter()
    for r in range(4):
        per_p, trig_p, keys_p, mids_p = _structure(port[r][0])
        per_r, trig_r, keys_r, mids_r = _structure(ref[r][0])
        assert per_p == per_r, r
        assert keys_p == keys_r, r
        assert mids_p == mids_r, r
        trig_port += trig_p
        trig_ref += trig_r
        # every rank logged the segmented allreduce and its phases
        assert per_p[("coll_dispatch", "pipeline_allreduce")] == 2
        assert per_p[("phase", "ph_rdv_wait")] > 0
    assert trig_port == trig_ref
    assert trig_port["ph_dispatch"] == trig_port["ph_execute"] > 0
    # collective correlation: every rank logged allreduce under the
    # same (cid, seq); every receiver's mid is some sender's
    ar = [next(e for e in evs if e["name"] == "allreduce")
          for evs, _ in port]
    assert len({(e["args"]["cid"], e["args"]["seq"]) for e in ar}) == 1
    sends = {m for evs, _ in port for n, m in _structure(evs)[3]
             if n == "send"}
    recvs = {m for evs, _ in port for n, m in _structure(evs)[3]
             if n == "recv"}
    assert recvs <= sends
    # finalize dumped one file per rank
    assert sorted(os.listdir(tmp_path / "port")) == [
        f"trace-r{r}.json" for r in range(4)]


# -- the cross-rank merge ---------------------------------------------------

def test_traceview_merges_clock_corrected(tmp_path):
    """Port dumps merge with the same corrected timeline and the same
    Chrome trace under the reference's traceview and the port's."""
    registry.set("trace_enable", "1")
    registry.set("trace_dump_path", str(tmp_path))
    run_ranks(4, _port_traffic)
    dumps = traceview.load_dumps([str(tmp_path / "*.json")])
    assert [d["rank"] for d in dumps] == [0, 1, 2, 3]
    offsets = [0.0, 1000.0, -500.0, 250.0]
    events = traceview.corrected_events(dumps, offsets)
    assert events == ref_traceview.corrected_events(dumps, offsets)
    raw1 = sorted(e["ts"] for d in dumps if d["rank"] == 1
                  for e in d["events"])
    base = min(e["ts"] - offsets[d["rank"]] / 1e6
               for d in dumps for e in d["events"])
    got1 = sorted(e["ts"] for e in events if e["rank"] == 1)
    want1 = sorted((t - offsets[1] / 1e6 - base) * 1e6 for t in raw1)
    assert got1 == pytest.approx(want1, abs=1.0)
    for r in range(4):
        ts = [e["ts"] for e in events if e["rank"] == r]
        assert ts == sorted(ts)
    doc = traceview.chrome_trace(dumps, offsets)
    assert json.dumps(doc) == json.dumps(
        ref_traceview.chrome_trace(dumps, offsets))
    evs = doc["traceEvents"]
    assert {e["ph"] for e in evs} <= {"M", "X", "i"}
    xs = [e for e in evs if e["ph"] == "X"]
    assert xs and all(
        {"name", "cat", "ts", "dur", "pid", "tid"} <= set(e) for e in xs)
    assert {e["pid"] for e in xs} == {0, 1, 2, 3}
    text = traceview.summary(dumps, offsets, top=3)
    assert text == ref_traceview.summary(dumps, offsets, top=3)
    assert "slowest" in text and "straggler" in text


def test_traceview_cli(tmp_path):
    registry.set("trace_enable", "1")
    registry.set("trace_dump_path", str(tmp_path))
    run_ranks(4, _port_traffic)
    sync = tmp_path / "sync.json"
    sync.write_text(json.dumps(
        {"offsets_us": [0.0, 40.0, -15.0, 5.0], "rtts_us": []}))
    out = tmp_path / "merged.json"
    rc = traceview.main([str(tmp_path / "trace-r*.json"),
                         "--sync", str(sync), "-o", str(out)])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert len([e for e in doc["traceEvents"] if e["ph"] == "X"]) > 0
    assert doc["otherData"]["ranks"]["0"]["dropped"] == 0


# -- the hot-path budget lint -----------------------------------------------

def test_hotpath_audit_clean():
    """Every hot function the port declares passes the AST lint."""
    from ompi_tpu_torch.tools import hotpath_audit
    assert hotpath_audit.audit() == []


def test_hotpath_audit_detects_regressions():
    from ompi_tpu_torch.tools import hotpath_audit
    bad = (
        "import time\n"
        "class Tracer:\n"
        "    def end(self):\n"
        "        x = (1, 2)\n"
        "        y = [3]\n"
        "        d = {'a': 1}\n"
        "        s = f'{x}'\n"
        "        z = dict(a=1)\n"
        "        return time.time()\n"
    )
    got = hotpath_audit.audit_source(bad, ("Tracer.end",), "fake.py")
    text = "\n".join(got)
    for what in ("tuple allocation", "list allocation",
                 "dict allocation", "f-string", "call to dict()",
                 "time.time reference"):
        assert what in text, f"lint missed: {what}"
    ok = "def f(pair):\n    a, b = pair\n    return a\n"
    assert hotpath_audit.audit_source(ok, ("f",), "fake.py") == []
    missing = hotpath_audit.audit_source(
        "def g():\n    pass\n", ("f",), "fake.py")
    assert missing and "not found" in missing[0]


# -- shared PERUSE instrumentation points -----------------------------------

def test_peruse_coll_and_nbc_events():
    events = []
    for ev in ("coll_begin", "coll_end", "nbc_activate",
               "nbc_complete", "req_activate", "req_complete"):
        peruse.subscribe(ev, lambda e, **kw: events.append((e, kw)))

    def fn(comm):
        x = np.ones(4, np.float32)
        r = np.zeros(4, np.float32)
        comm.Allreduce(x, r, port_op.SUM)
        rq = comm.Ibarrier()
        rq.wait()

    run_ranks(2, fn)
    kinds = [e for e, _ in events]
    for k in ("coll_begin", "coll_end", "nbc_activate", "nbc_complete",
              "req_activate", "req_complete"):
        assert k in kinds, k
    begins = [(kw["cid"], kw["seq"]) for e, kw in events
              if e == "coll_begin"]
    ends = [(kw["cid"], kw["seq"]) for e, kw in events
            if e == "coll_end"]
    assert sorted(begins) == sorted(ends)
    assert all(kw["coll"] for e, kw in events if e.startswith(("coll",
                                                              "nbc")))


def test_peruse_events_fire_without_tracer():
    """The shared hooks serve PERUSE alone: trace off, subscribe on."""
    assert not trace.enable_var.value
    seen = []
    peruse.subscribe("coll_begin", lambda e, **kw: seen.append(kw))

    def fn(comm):
        comm.Barrier()
        assert comm.state.tracer is None

    run_ranks(2, fn)
    assert seen and all("seq" in kw for kw in seen)
    with pytest.raises(ValueError):
        peruse.subscribe("no_such_event", lambda e, **kw: None)


# -- the compile span: a pinned divergence ----------------------------------

def test_divergence_compile_span_is_kernel_load(monkeypatch):
    """The reference records an XLA compile as ``xla_compile``; the port
    has none and records a kernel library's first-use build and load
    (kernels/build.load) as ``kernel_load`` under the same compile
    category, which critpath reads as the compile phase."""
    import types

    from ompi_tpu_torch.kernels import build
    from ompi_tpu_torch.tools import critpath

    assert "kernel_load" not in ref_trace._name_ids
    assert trace.PHASE_LABELS["kernel_load"] == "compile"
    assert critpath.PHASE_OF["kernel_load"] == "compile"
    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_all", lambda names=None: {})
    monkeypatch.setattr(build, "ctypes",
                        types.SimpleNamespace(CDLL=lambda path: path))
    registry.set("trace_enable", "1")

    def fn(comm):
        build.load("stacked")
        build.load("stacked")   # loaded: no second span
        return [(e["name"], e["cat"], e["args"])
                for e in comm.state.tracer.snapshot()
                if e["cat"] == "compile"]

    (got,) = run_ranks(1, fn)
    assert got == [("kernel_load", "compile", {"key": "stacked"})]


# -- pstat pvar idempotency -------------------------------------------------

def test_pstat_pvars_idempotent_across_worlds():
    """Looped worlds register each rank's opal_pstat_ pvars once, in
    both packages: the same names, never a duplicate."""
    names = {}
    for run, reg in ((run_ranks, registry), (ref_run_ranks, ref_registry)):
        for _ in range(4):
            run(2, lambda comm: comm.Barrier())
            got = [p.full_name for p in reg.all_pvars()
                   if p.full_name.startswith("opal_pstat_")]
            assert len(set(got)) == len(got)
            names.setdefault(reg, got)
            assert got == names[reg]
    for got in names.values():
        assert {f"opal_pstat_{k}_r{r}" for k in ("rss_mb", "threads")
                for r in (0, 1)} <= set(got)
