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
          "trace_phase_enable", "trace_phase_sample", "coll_sm_priority",
          *_PIPE_ON)


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
    # the port's meeting category comes after the reference's
    assert trace.SPAN_CATS == ref_trace.SPAN_CATS + ("meet",)
    assert [trace.bucket_upper_us(b) for b in range(trace.N_BUCKETS)] == \
        [ref_trace.bucket_upper_us(b) for b in range(trace.N_BUCKETS)]
    # the names interned at import are the reference's, in its order,
    # less ph_execute (the port has no execute fence); the port's own
    # compile span comes after them
    n = trace.NAME_KERNEL_LOAD
    assert trace._names[:n] == [x for x in ref_trace._names
                                if x != "ph_execute"][:n]
    assert "ph_execute" in ref_trace._name_ids
    assert "ph_execute" not in trace._name_ids
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

def _shared(got: dict) -> dict:
    """The port's sampling document less its meeting category (the
    reference has none), after checking that category is untouched:
    full fidelity, nothing dropped."""
    out = dict(got)
    for k, idle in (("dropped_by_cat", 0), ("rates", 1)):
        d = dict(out[k])
        assert d.pop("meet") == idle
        out[k] = d
    return out


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
    assert _shared(got) == _sample(ref_trace, cat, name, 100)
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
    assert _shared(got) == _sample(ref_trace, "coll", "meet", 200)
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
    assert got[3].pop("meet") == 0      # the port's meeting category
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
    ran before in the process.  The reference's ph_execute alone is
    not the port's: the port fences no execute phase."""
    static = {ref_trace._names[getattr(ref_trace, a)]
              for a in dir(ref_trace) if a.startswith("NAME_")}
    assert static - {"ph_execute"} <= set(trace._name_ids)
    assert "ph_execute" in static and "ph_execute" not in trace._name_ids
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

def test_trace_disabled_costs_nothing(monkeypatch):
    """trace_enable off (default): every layer's cached tracer slot is
    None — the single-attribute-check contract.  The meeting's record
    sites are never reached (its meet ctx is None), no body's launches
    are marked and no card anchor is made."""
    assert not trace.enable_var.value
    from ompi_tpu_torch.coll import device

    def boom(*a, **k):
        raise AssertionError("a meeting record site ran with tracing off")

    from ompi_tpu_torch.kernels import stacked
    for name in ("_meet_lock", "_meet_wait_end", "_meet_post",
                 "_marked_body", "_meet_device", "_make_anchor"):
        monkeypatch.setattr(device, name, boom)
    monkeypatch.setattr(stacked, "arm_marks", boom)
    anchors = dict(device._anchors)

    def fn(comm):
        assert comm.state.tracer is None
        assert comm.state.progress.tracer is None
        assert comm.state.pml._tracer is None
        assert trace.current_tracer() is None
        _port_traffic(comm)
        x = comm.allreduce_arr(torch.ones(16) * comm.rank, port_op.SUM)
        return comm.state.tracer is None and float(x[0]) == 1.0

    assert all(run_ranks(2, fn, device_map=lambda r: CPU))
    assert trace.global_tracer() is None
    assert device._anchors == anchors


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
# (the reference's ph_execute fence has no counterpart in the port)
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
    triggering rank's dispatch phases match as world totals.  Pinned
    divergence: the port records no ph_execute (it waits for no body on
    the card), where the reference fences one a dispatch.  The results
    are the same bytes."""
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
    assert trig_port["ph_dispatch"] == trig_ref["ph_dispatch"] > 0
    assert trig_ref["ph_execute"] == trig_ref["ph_dispatch"]
    assert trig_port["ph_execute"] == 0
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


# -- the meeting's spans (cat meet) ----------------------------------------

_MEET = ("meet_lock", "meet_wait", "meet_post", "meet_device")


def _meet_world(phase_sample: int = 0, nops: int = 6):
    """A traced 4-rank thread world of small ``allreduce_arr`` calls
    (one ``meet`` each on coll/hbm) and a Barrier (coll/sm's meeting);
    ``phase_sample`` > 0 arms the phase ctx at that period.  Returns
    each rank's snapshot."""
    knobs = {"trace_enable": "1", "trace_sample_auto": "0",
             "trace_buffer_events": "65536"}
    if phase_sample:
        knobs.update(trace_phase_enable="1",
                     trace_phase_sample=str(phase_sample))
    for k, v in knobs.items():
        registry.set(k, v)

    def fn(comm):
        x = torch.arange(16, dtype=torch.float32) + comm.rank
        for _ in range(nops):
            x = comm.allreduce_arr(x, port_op.SUM) * 0.25
        comm.Barrier()
        return comm.state.tracer.snapshot()

    return run_ranks(4, fn, device_map=lambda r: CPU, timeout=120)


def _keyed(events, name):
    return Counter((e["args"]["cid"], e["args"]["seq"]) for e in events
                   if e["name"] == name and e["ph"] == "X")


def test_meet_post_once_an_op():
    """Every op's meeting posts its results once: one ``meet_post``
    over the world a ``meet`` key, zero-length, in cat meet."""
    snaps = _meet_world()
    ops = _keyed(snaps[0], "meet")
    assert len(ops) == 7                     # 6 allreduces, the Barrier
    posts = Counter()
    for evs in snaps:
        assert _keyed(evs, "meet") == ops    # every rank met every op
        posts += _keyed(evs, "meet_post")
        assert all(e["dur"] == 0 and e["cat"] == "meet" for e in evs
                   if e["name"] == "meet_post")
    assert posts == ops


def test_meet_lock_and_wait_carry_the_op_key():
    """Each rank times the meeting's lock twice an op (``begin`` and
    ``finish``) and each of its two waits, keyed by the op's (cid,
    seq) as its ``meet`` span is; with the phase ctx off no wait is a
    ``ph_rdv_wait``."""
    for evs in _meet_world():
        ops = _keyed(evs, "meet")
        assert _keyed(evs, "meet_lock") == ops + ops
        assert _keyed(evs, "meet_wait") == ops + ops
        assert not _keyed(evs, "ph_rdv_wait")
        for e in evs:
            if e["name"] in ("meet_lock", "meet_wait"):
                assert e["cat"] == "meet" and e["dur"] >= 0


def test_sampled_in_op_waits_once_under_ph_rdv_wait():
    """An op that sampled into the phase ctx writes its waits as
    ``ph_rdv_wait`` and never also as ``meet_wait``; a sampled-out op
    writes them as ``meet_wait``; the lock and the post are recorded
    on both."""
    for evs in _meet_world(phase_sample=2):
        ops = _keyed(evs, "meet")
        rdv, wait = _keyed(evs, "ph_rdv_wait"), _keyed(evs, "meet_wait")
        assert rdv and wait
        assert not set(rdv) & set(wait)
        assert rdv + wait == ops + ops
        assert _keyed(evs, "meet_lock") == ops + ops
        assert sum(e["name"] == "ph_execute" for e in evs) == 0


def test_meet_category_counted_in_sampling():
    """The meet category is a span category: its spans count as seen
    and kept, it runs at period 1, and its drops are exact (none)."""
    registry.set("trace_enable", "1")
    registry.set("trace_sample_auto", "0")

    def fn(comm):
        comm.allreduce_arr(torch.ones(8), port_op.SUM)
        tr = comm.state.tracer
        return (tr.sampling_rates()["meet"], tr.dropped_by_cat()["meet"],
                tr.cat_seen("meet"), tr.span_count("meet"),
                _pvar("trace_dropped_meet"))

    for rate, dropped, seen, spans, pv in run_ranks(
            2, fn, device_map=lambda r: CPU):
        assert rate == 1 and dropped == 0 and pv == 0
        assert seen == spans >= 4            # 2 locks, 2 waits


def test_finalize_dump_carries_the_meeting(tmp_path):
    """The finalize dump (``trace_dump_path``) holds each rank's
    meeting spans with the op's keys and the category's accounting:
    what a reader of a finished run works from."""
    registry.set("trace_dump_path", str(tmp_path))
    _meet_world(nops=2)
    docs = [json.loads((tmp_path / f"trace-r{r}.json").read_text())
            for r in range(4)]
    posts = Counter()
    for doc in docs:
        evs = doc["events"]
        ops = _keyed(evs, "meet")
        # 2 allreduces, the Barrier, and finalize's own meetings
        assert len(ops) >= 3 and ops == _keyed(docs[0]["events"], "meet")
        assert _keyed(evs, "meet_lock") == ops + ops
        posts += _keyed(evs, "meet_post")
        assert doc["dropped_by_cat"]["meet"] == 0
        assert doc["sampling"]["meet"] == 1
        assert doc["anchor"]["perf_ns"] > 0
    assert posts == ops


def test_meet_category_samples_and_backs_off():
    """The meet ctx is gated by its own category: ``meet:2`` records
    the meeting of every other op (the rest counted sampled out), and
    with adaptation on the category backs off like any other."""
    registry.set("trace_sample_spec", "meet:2")
    for evs in _meet_world(nops=7):
        ops = _keyed(evs, "meet")
        assert len(ops) == 8
        locks = _keyed(evs, "meet_lock")
        assert len(locks) == 4 and set(locks) < set(ops)
        assert set(locks.values()) == {2}
    registry.set("trace_sample_spec", "")
    registry.set("trace_enable", "1")
    registry.set("trace_sample_auto", "4")
    registry.set("trace_sample_max", "8")

    def fn(comm):
        for _ in range(40):
            comm.allreduce_arr(torch.ones(8), port_op.SUM)
        tr = comm.state.tracer
        return tr.sampling_rates()["meet"], tr.cat_seen("meet")

    for rate, seen in run_ranks(2, fn, device_map=lambda r: CPU):
        assert rate == 8 and seen > 0


class _StubEvent:
    """A CUDA event stand-in: done once ``done`` is set, ``ms`` past
    the anchor's event on the card's clock."""

    def __init__(self, ms: float, done: bool = True) -> None:
        self.ms, self.done, self.waits = ms, done, 0

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waits += 1
        self.done = True

    def elapsed_time(self, other) -> float:
        return other.ms - self.ms


def _anchor(monkeypatch, ms: float, ns: int):
    """The port's card anchor over a stand-in clock reading: its event
    at ``ms`` on the card's clock is host ``ns``."""
    from ompi_tpu_torch.coll import device
    monkeypatch.setattr(device, "_clock_reading",
                        lambda dev: (_StubEvent(ms), ns))
    return device._Anchor("card")


def test_meet_device_pair_resolves_onto_the_anchor(monkeypatch):
    """A queued pair stays out of the ring until its end event reports
    done (``query``, never a wait), then lands as ``meet_device`` at the
    anchor's host ns plus the events' ms past the anchor's event."""
    tr = trace.Tracer(0, capacity=16)
    anchor = _anchor(monkeypatch, 1.0, 5_000_000_000)
    e0, e1 = _StubEvent(3.5), _StubEvent(9.0, done=False)
    tr.device_pair(e0, e1, anchor, 7, 42, 0)
    assert tr.snapshot() == [] and tr._dv_n == 1
    assert e0.waits == e1.waits == 0
    e1.done = True
    (e,) = tr.snapshot()
    assert tr._dv_n == 0 and tr._dv_e1[0] is None
    assert (tr._ts[0], tr._dur[0]) == (5_002_500_000, 5_500_000)
    assert e["ts"] == tr._wall(5_002_500_000)
    assert (e["name"], e["cat"], e["args"]) == (
        "meet_device", "meet", {"cid": 7, "seq": 42, "card": 0})
    assert e["dur"] == pytest.approx(5.5e-3)


def test_anchor_fits_its_probes(monkeypatch):
    """The card's anchor converts at its reading alone until it holds
    ``ANCHOR_MIN_PROBES`` probes (start events recorded on an idle
    stream, with the host ns then); then it adds the line through the
    median residual of the earliest and the latest third of them (here
    20 µs at the reading and a card clock 4 parts in a million slow),
    which two wild probes do not move; probes spanning less than
    ``ANCHOR_BASE_MS`` give the offset alone.  A tracer gives its
    finished pairs' probes to their anchor before it converts them, and
    never waits for a pair still running."""
    from ompi_tpu_torch.coll import device
    assert (device.ANCHOR_MIN_PROBES, device.ANCHOR_BASE_MS) == (16, 1e4)
    base = 10**9
    anchor = _anchor(monkeypatch, 0.0, base)
    late = _StubEvent(30_000.0)
    for k in range(1, 25):
        ms = 1_000.0 * k
        anchor.probe(_StubEvent(ms), base + int(ms * 1e6) + 20_000
                     + int(4 * ms) + (300_000 if k in (3, 20) else 0))
        if k == 15:
            assert anchor.host_ns(late) == base + 30_000_000_000
    assert anchor.host_ns(late) == base + 30_000_000_000 + 20_000 + 120_000
    assert anchor.b == pytest.approx(4.0) and anchor.a == 20_000
    near = _anchor(monkeypatch, 0.0, base)
    for k in range(16):
        near.probe(_StubEvent(100.0 * k), base + 10**8 * k + 7_000)
    assert near.host_ns(late) == base + 30_000_007_000 and near.b == 0
    tr = trace.Tracer(0, capacity=16)
    e1 = _StubEvent(31_001.0, done=False)
    tr.device_pair(_StubEvent(25_000.0), _StubEvent(25_000.5), anchor,
                   1, 0, 0, base + 25_000_120_000)
    tr.device_pair(_StubEvent(31_000.0), e1, anchor, 1, 1, 0,
                   base + 31_000_144_000)
    (e,) = tr.snapshot()
    assert len(anchor.ms) == 25 and anchor.ms[-1] == 25_000.0
    assert (tr._ts[0], tr._dur[0]) == (base + 25_000_120_000, 500_002)
    assert e["args"] == {"cid": 1, "seq": 0, "card": 0}
    assert e1.waits == 0 and tr._dv_n == 1
    assert tr._dv_idle[0] == base + 31_000_144_000


def test_meet_device_full_list_resolves_or_counts_the_drop(tmp_path,
                                                           monkeypatch):
    """A full list resolves its finished pairs in place; full of
    unfinished ones, the new pair is counted dropped (never a wait on
    the hot path).  The finalize dump waits for the rest."""
    tr = trace.Tracer(0, capacity=4 * trace.DEVICE_PAIRS)
    anchor = _anchor(monkeypatch, 0.0, 0)
    ends = [_StubEvent(i + 1.0, done=False)
            for i in range(trace.DEVICE_PAIRS)]
    for i, e1 in enumerate(ends):
        tr.device_pair(_StubEvent(float(i)), e1, anchor, 1, i, 0)
    tr.device_pair(_StubEvent(0.0), _StubEvent(1.0), anchor, 1, -1, 0)
    assert tr.dropped_by_cat()["meet"] == 1
    assert tr._dv_n == trace.DEVICE_PAIRS and tr.cursor == 0
    for e1 in ends[:10]:
        e1.done = True
    tr.device_pair(_StubEvent(0.0), _StubEvent(1.0), anchor, 1, 10**6, 0)
    assert tr.span_count("meet") == 10
    assert tr._dv_n == trace.DEVICE_PAIRS - 10 + 1
    assert [tr._dv_seq[i] for i in range(3)] == [10, 11, 12]
    assert sum(e.waits for e in ends) == 0
    tr.dump(str(tmp_path / "t.json"))
    assert tr._dv_n == 0 and sum(e.waits for e in ends) == \
        trace.DEVICE_PAIRS - 10
    doc = json.loads((tmp_path / "t.json").read_text())
    assert sum(e["name"] == "meet_device" for e in doc["events"]) == \
        trace.DEVICE_PAIRS + 1
    assert doc["dropped_by_cat"]["meet"] == 1


def test_meet_record_sites_retain_no_objects(monkeypatch):
    """The meeting's record calls allocate nothing that survives them:
    a zero-length ``point`` and a queued device pair (the stub events
    reused), thousands of times, ring wraparound included."""
    tr = trace.Tracer(0, capacity=256)
    anchor = _anchor(monkeypatch, 0.0, 0)
    e0, e1 = _StubEvent(1.0), _StubEvent(2.0)

    def burst(n):
        for i in range(n):
            tr.point(trace.NAME_MEET_POST, trace.CAT_MEET, 1, i, 64)
            tr.device_pair(e0, e1, anchor, 1, i, 0)

    burst(2048)
    gc.collect()
    tracemalloc.start()
    base = tracemalloc.get_traced_memory()[0]
    burst(4000)
    gc.collect()
    grown = tracemalloc.get_traced_memory()[0] - base
    tracemalloc.stop()
    assert grown < 4096, f"record sites retained {grown} bytes"
    assert tr.span_count("meet") == tr.capacity
    assert tr.resolve_device() == 0
    tr.point(trace.NAME_MEET_POST, trace.CAT_MEET, 1, 0, 64)
    last = tr.snapshot()[-1]
    assert (last["name"], last["dur"]) == ("meet_post", 0)


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
