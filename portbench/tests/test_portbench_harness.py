"""CPU tests of the benchmark's yardstick: cells resolve by name, the
metric arithmetic, the plain reference, the trace reduction, and what
a run loads.  Run with ``python -m pytest portbench/tests -q``."""

import ast
import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from portbench import devtrace, reference, spec, traffic, yardstick
from portbench.spec import ROOT

BENCH = os.path.join(ROOT, "BENCHMARK.json")
MiB = 1 << 20


def _bench():
    with open(BENCH) as fh:
        return json.load(fh)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_resolves_by_name(cell):
    c = spec.resolve(cell)
    assert c.config["ranks"] >= 2 and c.config["cards"] >= 1
    assert set(c.limits) == {"max_err", "bad"}
    names = {m["name"] for m in c.end_to_end + c.per_layer}
    assert {"setup_s", "busbw_GBps"} <= names
    assert names == set(c.readers)
    assert any(m in names for m in ("rdv_wait_ms", "kernel_roofline_pct"))
    traffic.Mix.from_dict(c.traffic_name, c.traffic).validate(
        c.config["ranks"])


def test_a_new_cell_mix_and_metric_are_found_without_an_edit(tmp_path):
    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    bench = _bench()
    (root / "portbench" / "traffic" / "bcast-8m.json").write_text(json.dumps(
        {"op": "bcast", "dtype": "float32", "elements": 2 * MiB,
         "buffers": 2, "ops_per_step": 2}))
    (root / "portbench" / "metrics" / "ops_seen.py").write_text(
        "def read(run):\n    return float(run.ops)\n")
    (root / "portbench" / "limits" / "colo8.bcast-8m.json").write_text(
        '{"max_err": 0, "bad": 0}')
    bench["workloads"].append({"name": "colo8.bcast-8m", "config": "colo8",
                               "traffic": "bcast-8m", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "ops_seen", "unit": "ops",
                               "better": "higher", "source": "host_clock",
                               "layer": "the device", "moves": "busbw_GBps",
                               "workloads": ["colo8.bcast-8m"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = spec.resolve("colo8.bcast-8m", root=str(root),
                     base=str(root / "portbench"))
    assert c.traffic["op"] == "bcast"
    assert c.readers["ops_seen"](SimpleNamespace(ops=12)) == 12.0
    assert "ops_seen" not in spec.resolve(
        "colo8.allreduce-1g", root=str(root),
        base=str(root / "portbench")).readers
    for p, data in before.items():
        assert p.read_bytes() == data


def test_unknown_cell_and_missing_file_raise(tmp_path):
    with pytest.raises(KeyError):
        spec.resolve("no.such-cell")
    with pytest.raises(FileNotFoundError):
        spec.load_reader("no_such_metric")


def _run(steps, ops_per_step, kind="allreduce", nranks=8, send=256 * MiB):
    return SimpleNamespace(
        steps_ns=steps, window_ns=(steps[0][0], steps[-1][1]),
        ops=len(steps) * ops_per_step,
        bus_bytes_per_op=yardstick.bus_bytes(kind, nranks, send),
        setup_s=12.5, nranks=nranks)


def test_busbw_counts_every_op_over_the_whole_window():
    read = spec.load_reader("busbw_GBps")
    # 10 steps of 20 ms back to back, 4 ops of 2(P-1)/P * 256 MiB each
    steps = [(i * 20_000_000, (i + 1) * 20_000_000) for i in range(10)]
    got = read(_run(steps, 4))
    want = 40 * 1.75 * 256 * MiB / 0.2 / 1e9
    assert got == pytest.approx(want, rel=1e-12)
    # a gap between steps counts against the rate
    gapped = steps[:5] + [(s + 100_000_000, e + 100_000_000)
                          for s, e in steps[5:]]
    assert read(_run(gapped, 4)) == pytest.approx(want * 0.2 / 0.3)


def test_percentile_is_the_nearest_rank():
    assert yardstick.percentile(list(range(1, 101)), 95) == 95
    assert yardstick.percentile([5.0], 95) == 5.0
    assert yardstick.percentile(list(range(1, 21)), 95) == 19


def test_the_traced_runs_busbw_is_read_only_with_a_trace():
    read = spec.load_reader("busbw_traced_GBps")
    steps = [(i * 20_000_000, (i + 1) * 20_000_000) for i in range(10)]
    run = _run(steps, 4)
    run.dev = None
    assert read(run) is None
    run.dev = SimpleNamespace()
    assert read(run) == pytest.approx(spec.load_reader("busbw_GBps")(run))


def test_rdv_wait_is_a_mean_a_traced_op_a_rank_without_the_fence():
    read = spec.load_reader("rdv_wait_ms")
    ms = 1_000_000
    a, b = (0, 16), (0, 32)           # two traced ops: (cid, seq)
    phases = [
        # rank 0 triggers op a (its body fenced 10..16 ms), waits 1 ms
        # before op b's deposit and 0.5 ms for b's result
        {"ph_rdv_wait": [(9 * ms, 10 * ms, a), (50 * ms, 51 * ms, b),
                         (52 * ms, 52 * ms + ms // 2, b)],
         "ph_execute": [(10 * ms, 16 * ms, a)]},
        # rank 1 waits through op a's fence: 4 ms before it, 6 ms in it
        {"ph_rdv_wait": [(6 * ms, 16 * ms, a), (50 * ms, 53 * ms, b)],
         "ph_execute": []},
    ]
    run = SimpleNamespace(phases=phases, phase_lost=0)
    # (rank 0: 1 + 1.5; rank 1: 4 + 3) / 4 waits
    assert read(run) == pytest.approx((1 + 1.5 + 4 + 3) / 4)
    assert read(SimpleNamespace(phases=phases, phase_lost=3)) is None
    assert read(SimpleNamespace(phases=None, phase_lost=0)) is None
    assert read(SimpleNamespace(phases=[{"ph_rdv_wait": []}],
                                phase_lost=0)) is None


def test_bus_bytes_follow_nccl_tests():
    s = 100
    assert yardstick.bus_bytes("allreduce", 8, s) == pytest.approx(175)
    assert yardstick.bus_bytes("reduce_scatter", 8, s) == pytest.approx(87.5)
    assert yardstick.bus_bytes("allgather", 4, s) == pytest.approx(300)
    assert yardstick.bus_bytes("bcast", 4, s) == 100


def test_least_time_of_each_cell():
    pk = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]
    s = 256 * MiB
    # colo8 allreduce: P*S read once and P*S written once at 3.35 TB/s
    assert yardstick.least_time_s("allreduce", 8, 1, s, pk) == \
        pytest.approx(16 * s / 3.35e12)
    assert yardstick.least_time_s("allreduce", 8, 1, s, pk) * 1e3 == \
        pytest.approx(1.2820, abs=1e-4)
    # nvl4: 2(P-1)/P*S in over NVLink at 450 GB/s beats 2S of HBM
    assert yardstick.least_time_s("allreduce", 4, 4, s, pk) == \
        pytest.approx(1.5 * s / 450e9)
    assert yardstick.least_time_s("allreduce", 4, 4, s, pk) * 1e3 == \
        pytest.approx(0.8948, abs=1e-4)
    # rsvec: 8 ranks' selected elements read once, S of results written
    assert yardstick.least_time_s("reduce_scatter", 8, 1, s, pk) == \
        pytest.approx(9 * s / 3.35e12)
    assert yardstick.least_time_s("reduce_scatter", 8, 1, s, pk) * 1e3 == \
        pytest.approx(0.7211, abs=1e-4)
    with pytest.raises(ValueError):
        yardstick.least_time_s("allreduce", 8, 4, s, pk)


def test_spread_is_the_interquartile_range_over_the_median():
    assert yardstick.spread([1, 2, 3, 4, 5, 6]) == pytest.approx(
        (5.25 - 1.75) / 3.5)


def test_reference_against_hand_values():
    xs = [torch.tensor([1.0, -2.0, 3.0, 4.0]),
          torch.tensor([0.5, 5.0, -1.0, 2.0])]
    seg = reference.plan("allreduce", 0, 2, 4)
    assert seg == [(0, 4, (0, 1), 0)]
    got = reference.expected(xs, seg[0], 0, 4, "sum", 1, "cpu")
    assert got.dtype == torch.float64
    assert got.tolist() == [1.5, 3.0, 2.0, 6.0]
    assert reference.expected(xs, seg[0], 1, 3, "max", 1, "cpu").tolist() \
        == [5.0, 3.0]
    # reduce_scatter: rank 1 gets block 1 of the reduction
    (s,) = reference.plan("reduce_scatter", 1, 2, 4)
    assert reference.expected(xs, s, 0, 2, "max", 1, "cpu").tolist() \
        == [3.0, 4.0]
    assert reference.expected(xs, s, 0, 2, "min", 1, "cpu").tolist() \
        == [-1.0, 2.0]
    # alltoall: rank 0 gets block 0 of each rank, in rank order
    out = reference.output(xs, "alltoall", None, 0, 4, 1, 7.0, "cpu")
    assert out.tolist() == [1.0, -2.0, 0.5, 5.0]
    assert reference.output(xs, "allgather", None, 1, 4, 1, 7.0,
                            "cpu").tolist() == xs[0].tolist() + xs[1].tolist()
    assert reference.output(xs, "bcast", None, 0, 4, 1, 7.0, "cpu",
                            root=1).tolist() == xs[1].tolist()


def test_reference_vector_pack_and_unpack():
    span = torch.tensor([1.0, 9.0, 2.0, 9.0, 3.0, 9.0, 4.0, 9.0],
                        dtype=torch.float64)
    assert reference.packed(span, 2).tolist() == [1.0, 2.0, 3.0, 4.0]
    other = torch.tensor([5.0, 9.0, 0.0, 9.0, 6.0, 9.0, -1.0, 9.0],
                         dtype=torch.float64)
    # rank 0's block of a MAX reduce_scatter over two ranks, unpacked at
    # stride 2 with its gaps at the fill
    out = reference.output([span, other], "reduce_scatter", "max", 0, 4, 2,
                           7.0, "cpu")
    assert out.tolist() == [5.0, 7.0, 2.0, 7.0]


def test_reference_sums_in_float64_and_the_control_one_step_down():
    xs = [torch.tensor([1.0], dtype=torch.float32),
          torch.tensor([2.0 ** -30], dtype=torch.float32)]
    seg = (0, 1, (0, 1), 0)
    assert reference.expected(xs, seg, 0, 1, "sum", 1, "cpu").item() == \
        1.0 + 2.0 ** -30
    low = reference.expected(xs, seg, 0, 1, "sum", 1, "cpu",
                             dtype=torch.bfloat16)
    assert low.dtype == torch.bfloat16 and low.item() == 1.0


def test_inputs_and_stamps_come_from_the_seed():
    mix = traffic.Mix.from_dict("t", {"op": "reduce_scatter", "reduce": "max",
                                      "dtype": "float64", "elements": 64,
                                      "stride": 2, "buffers": 2,
                                      "ops_per_step": 2})
    a = traffic.make_inputs(mix, 2**33 + 5, 3, "cpu")
    b = traffic.make_inputs(mix, 2**33 + 5, 3, "cpu")
    c = traffic.make_inputs(mix, 2**33 + 6, 3, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], a[1])
    assert a[0].numel() == 128
    assert (a[0][1::2] == traffic.SEND_FILL["max"]).all()
    assert (a[0][0::2].abs() < 1).all()
    assert [mix.buffer_of(k, j) for k in range(3) for j in range(2)] == \
        [0, 1, 1, 0, 0, 1]
    # 16 packed elements spread over the span, a row of values an op
    st = traffic.Stamps(mix, 2**33 + 5, 3, "cpu")
    assert st.index.tolist() == list(range(0, 128, 8))
    assert torch.equal(st.table,
                       traffic.Stamps(mix, 2**33 + 5, 3, "cpu").table)
    assert not torch.equal(st.table,
                           traffic.Stamps(mix, 2**33 + 5, 2, "cpu").table)
    x = a[0].clone()
    st.apply(x, 5)
    assert torch.equal(x[0::8], st.table[5])
    assert torch.equal(x[1::2], a[0][1::2])
    st.apply(x, 5 + traffic.STAMP_ROWS)
    assert torch.equal(x[0::8], st.table[5])
    assert not torch.equal(st.table[5], st.table[6])
    with pytest.raises(ValueError):
        traffic.Mix.from_dict("t", {"op": "allreduce", "reduce": "sum",
                                    "dtype": "float32", "elements": 64,
                                    "buffers": 1,
                                    "ops_per_step": 2}).validate(8)


def test_trace_reduction_busy_gaps_and_names():
    ms = 1_000_000
    ev = [(0, "k1", 0 * ms, 4 * ms), (0, "k1", 2 * ms, 6 * ms),
          (0, "memcpy", 8 * ms, 9 * ms), (1, "k6", 1 * ms, 3 * ms),
          (0, "k1", -5 * ms, 1 * ms), (1, "late", 12 * ms, 15 * ms)]
    dt = devtrace.reduce(ev, (0, 10 * ms), [0, 1])
    assert dt.busy_ns == {0: 7 * ms, 1: 2 * ms}
    assert dt.busy_s == pytest.approx(4.5e-3)
    assert dt.window_s == pytest.approx(0.01)
    # by name, each event's time in the window counts, overlaps and all
    assert dt.by_name[0] == ("k1", pytest.approx(9e-3))
    assert [g[:2] for g in dt.gaps] == [(7 * ms, 1), (2 * ms, 0),
                                       (1 * ms, 1), (1 * ms, 0)]
    host = devtrace.HostSpans(
        [[(0, 0, 5 * ms), (3, 5 * ms, 9 * ms)], [(3, 4 * ms, 8 * ms)]],
        traffic.Caller.NAMES)
    devtrace.name_gaps(dt, host)
    assert dt.named_gaps[0] == ("cuda:1 idle, host sync[r0-1]",
                                pytest.approx(7e-3))
    assert host.at(7 * ms) == "sync[r0-1]"
    assert host.at(1 * ms) == "call[r0] harness[r1]"


def test_alignment_puts_the_wall_clock_on_the_harness_clock():
    raw = [(0, "k", 10**18 + 5, 10**18 + 9)]
    assert devtrace.align(raw, -10**18, (0, 100)) == [(0, "k", 5, 9)]
    assert devtrace.align([], 0, (0, 100)) == []
    with pytest.raises(ValueError):
        devtrace.align(raw, 0, (0, 100))
    off = devtrace.clock_offset()
    import time
    assert abs(time.time_ns() + off - time.perf_counter_ns()) < 10**8


def test_roofline_and_idle_readers():
    roof = spec.load_reader("kernel_roofline_pct")
    idle = spec.load_reader("device_idle_pct")
    dev = SimpleNamespace(busy_s=2.0, window_s=8.0, n_events=10)
    run = SimpleNamespace(dev=dev, least_s=1e-3, ops=1000)
    assert roof(run) == pytest.approx(50.0)
    assert idle(run) == pytest.approx(75.0)
    assert roof(SimpleNamespace(dev=None, least_s=1e-3, ops=1)) is None
    assert idle(SimpleNamespace(dev=None)) is None


def test_reference_imports_nothing_of_the_program():
    src = open(os.path.join(ROOT, "portbench", "reference.py")).read()
    names = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert names <= {"__future__", "typing", "torch"}
    out = subprocess.run(
        [sys.executable, "-c", "import sys; import portbench.reference; "
         "print(sorted(m for m in sys.modules if m.split('.')[0] in "
         "('ompi_tpu_torch', 'ompi_tpu', 'jax', 'jaxlib')))"],
        cwd=ROOT, capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_cpu_rehearsal_loads_no_jax_and_says_it_is_not_a_measurement():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "colo8.allreduce-1g", "--seed", str(2**31 + 77), "--seconds",
         "0.3", "--trace", "1", "--cpu", "--scale", "1024"],
        cwd=ROOT, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert "metrics" not in line and "rehearsal" in line
    assert "compared max_err" in out.stderr


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(BENCH, tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for extra in ([], ["--cpu"]):
        out = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "colo8.allreduce-1g", "--seed", "1", "--seconds", "1",
             "--trace", "0"] + extra, cwd=tmp_path, capture_output=True,
            text=True, timeout=120)
        assert out.returncode != 0
        assert "{" not in out.stdout


@pytest.mark.gpu
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "colo8.allreduce-1g", "--seed", "5", "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
