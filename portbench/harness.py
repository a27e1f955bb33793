"""One run of one cell: set-up, window, check, metrics, the result line.

``run.py`` calls ``main``.  On the card (a measured run) the run
needs ``torch.cuda`` with at least the configuration's cards, and
prints no result without them.  ``--cpu`` is a rehearsal at a size cut
by ``--scale`` on the CPU, with the program's plain kernel versions: it
prints a line that says so and carries no metric.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "ompi_tpu")
PHASES = ("ph_rdv_wait", "ph_execute")
# the port fences a traced op's body on the card (coll/device.py
# _phase_fn): tracing 1 op in 16 keeps the other 15 pipelined
PHASE_SAMPLE = 16
WORLD_TIMEOUT = 300.0


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (names compared whole: ``ompi_tpu_torch`` is not ``ompi_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU with the plain kernel versions")
    ap.add_argument("--scale", type=int, default=256,
                    help="with --cpu: divide the mix's elements by this")
    return ap.parse_args(argv)


@dataclass
class Run:
    """What a metric's reader reads (``metrics/<name>.py``)."""
    cell: object                 # spec.Cell
    mix: object                  # traffic.Mix
    nranks: int
    cards: int
    setup_s: float
    steps_ns: List[tuple]        # world-level (start, end) of each step
    window_ns: tuple
    ops: int                     # collective ops completed in the window
    bus_bytes_per_op: float
    spans: List[list]            # rank -> [(code, start, end)]
    phases: Optional[List[dict]]  # rank -> {name: [(start, end, op key)]}
    phase_lost: int
    dev: Optional[object]        # devtrace.DevTrace (traced card runs)
    least_s: Optional[float]     # least device time of an op on a card
    route: Dict[str, float]      # route and launch counters an op


def process_start_perf() -> float:
    """The process's start on the perf_counter clock (Linux; else now)."""
    now = time.perf_counter()
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        boot = time.clock_gettime(time.CLOCK_BOOTTIME)
        return now - (boot - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return now


def _devices(config: dict, cpu: bool):
    import torch
    from ompi_tpu_torch.testing import logical_devices
    n, cards = int(config["ranks"]), int(config["cards"])
    if cpu:
        if cards == 1:
            return [torch.device("cpu")] * n
        ld = logical_devices("cpu")
        return [ld(r) for r in range(n)]
    return [torch.device("cuda", r % cards) for r in range(n)]


def _check_cards(chips: int) -> Optional[str]:
    import torch
    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards and torch sees "
                f"{torch.cuda.device_count()}")
    return None


ROUTE_PVARS = ("coll_plan_builds", "coll_plan_hits", "coll_pipeline_ops",
               "coll_pipeline_segments", "coll_tpu_offloaded_collectives")
ROUTE_WRAPPERS = (("stacked", "stacked_reduce"), ("stacked", "stacked_copy"),
                  ("stacked", "peer_copy"), ("mesh", "mesh_fold"),
                  ("index", "index_gather"), ("index", "index_scatter"),
                  ("fused", "fused_batch"))


def route_counts() -> Dict[str, float]:
    """The port's route counters and kernel launch counters (plain
    versions on the CPU never count a launch): which tier an op took."""
    import importlib
    from ompi_tpu_torch.mca.params import registry
    pv = {p.full_name: p for p in registry.all_pvars()}
    out = {n: float(pv[n].read()) for n in ROUTE_PVARS if n in pv}
    for mod, fn in ROUTE_WRAPPERS:
        m = importlib.import_module(f"ompi_tpu_torch.kernels.{mod}")
        launches = getattr(getattr(m, fn, None), "launches", None)
        if launches is not None:
            out[fn] = float(launches.value)
    return out


def set_trace_knobs(ring: int) -> None:
    """The port's tracing for a --trace 1 run: the phase spans of one op
    in ``PHASE_SAMPLE``, at a fixed period."""
    from ompi_tpu_torch.mca.params import registry
    for k, v in (("trace_enable", True), ("trace_phase_enable", True),
                 ("trace_phase_sample", PHASE_SAMPLE),
                 ("trace_sample_auto", 0), ("trace_buffer_events", ring)):
        registry.set(k, v)


def execute(cell, seed: int, seconds: float, trace: bool, cpu: bool,
            scale: int, t_start: float):
    """Run the cell once; returns (Run, device info, numbers, kept)."""
    import torch
    from portbench import devtrace, traffic, world, yardstick
    import ompi_tpu_torch.trace  # noqa: F401 - registers the trace knobs

    mix = traffic.Mix.from_dict(cell.traffic_name, cell.traffic,
                                scale if cpu else 1)
    n, cards = int(cell.config["ranks"]), int(cell.config["cards"])
    mix.validate(n)
    devices = _devices(cell.config, cpu)
    dev_of = [getattr(d, "device", d) for d in devices]
    if trace:
        set_trace_knobs(1 << 19)
    sends = [traffic.make_inputs(mix, seed, r, dev_of[r]) for r in range(n)]
    stamps = [traffic.Stamps(mix, seed, r, dev_of[r]) for r in range(n)]

    if cpu:
        def sync(dev):
            return None
    else:
        def sync(dev):
            torch.cuda.synchronize(dev)

    prof_box: Dict[str, object] = {}
    profiling = trace and not cpu

    def before():
        prof_box["route0"] = route_counts()
        if profiling:
            from torch.profiler import ProfilerActivity, profile
            prof_box["prof"] = p = profile(activities=[ProfilerActivity.CUDA])
            p.start()
            prof_box["offset"] = devtrace.clock_offset()

    def after():
        if profiling:
            prof_box["prof"].stop()
        prof_box["route1"] = route_counts()

    spec = world.WorldSpec(mix, seed, seconds, devices, sends, stamps, sync,
                           before, after, PHASES if trace else ())
    records = world.run_world(spec, lambda r: devices[r], WORLD_TIMEOUT)
    nsteps = len(records[0].steps)
    steps = [(min(rec.steps[k][0] for rec in records),
              max(rec.steps[k][1] for rec in records)) for k in range(nsteps)]
    window = (steps[0][0], steps[-1][1])
    setup_s = steps[0][0] * 1e-9 - t_start

    info = {"platform": "cpu" if cpu else "gpu", "count": cards}
    if not cpu:
        info["kind"] = torch.cuda.get_device_name(0)
        info["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(c) for c in range(cards))
    dev = None
    if "prof" in prof_box:
        raw = devtrace.profiler_events(prof_box["prof"])
        events = devtrace.align(raw, prof_box["offset"], window)
        print(f"portbench: {len(raw)} device events in the trace on cards "
              f"{sorted({e[0] for e in raw})}", file=sys.stderr)
        dev = devtrace.reduce(events, window, list(range(cards)))
        devtrace.name_gaps(dev, devtrace.HostSpans(
            [rec.spans for rec in records], traffic.Caller.NAMES))
        info["busy_s"] = dev.busy_s
        info["window_s"] = dev.window_s
        del prof_box["prof"]
    peaks = None if cpu else yardstick.peaks_for(info.get("kind"))
    least = None if peaks is None else yardstick.least_time_s(
        mix.kind, n, cards, mix.send_bytes, peaks)
    ops = nsteps * mix.ops_per_step
    route = {k: (v - prof_box["route0"].get(k, 0.0)) / ops
             for k, v in prof_box["route1"].items()}
    run = Run(cell, mix, n, cards, setup_s, steps, window, ops,
              yardstick.bus_bytes(mix.kind, n, mix.send_bytes),
              [rec.spans for rec in records],
              [rec.phases for rec in records] if trace else None,
              sum(rec.phase_lost for rec in records), dev, least, route)

    # the program's state is gone with its world; the outputs the ranks
    # kept are judged against the reference, computed anew from the inputs
    kept = [(rec.rank, b, row, y) for rec in records for slot in rec.kept
            for b, row, y in slot.outs]
    del records
    gc.collect()
    if not cpu:
        torch.cuda.empty_cache()
    from portbench import check
    numbers = check.compare(mix, sends, stamps, kept)
    return run, info, numbers, len(kept)


def _diagnose(run: Run) -> None:
    """Standard error: the step times' quantiles and the bus bandwidth of
    each second of the window (for looking at a run's spread)."""
    from portbench.yardstick import percentile
    ms = [(e - s) * 1e-6 for s, e in run.steps_ns]
    q = {p: round(percentile(ms, p), 3) for p in (5, 50, 95, 100)}
    w0 = run.window_ns[0]
    per: Dict[int, int] = {}
    for s, e in run.steps_ns:
        per[int((e - w0) // 10**9)] = per.get(int((e - w0) // 10**9), 0) + 1
    rate = [round(per.get(i, 0) * run.mix.ops_per_step
                  * run.bus_bytes_per_op / 1e9, 1)
            for i in range(max(per) + 1)]
    print(f"portbench: {len(ms)} steps, step ms by percentile {q}; "
          f"GB/s by second {rate}", file=sys.stderr)


def metrics_of(run: Run, entries: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in entries:
        v = run.cell.readers[m["name"]](run)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def breakdown(run: Run) -> Optional[dict]:
    if run.dev is None:
        return None
    return {"device_ops": [[n[:160], s] for n, s in run.dev.by_name[:10]],
            "idle_gaps": [[n, s] for n, s in run.dev.named_gaps[:10]]}


def main(argv, t_start: Optional[float] = None) -> int:
    t_start = process_start_perf() if t_start is None else t_start
    args = parse(argv)
    from portbench import spec
    cell = spec.resolve(args.workload)
    if not args.cpu:
        why = _check_cards(cell.chips)
        if why:
            print(f"portbench: {why}; no result", file=sys.stderr)
            return 2
    from portbench import check
    run, info, numbers, nkept = execute(
        cell, args.seed, args.seconds, bool(args.trace), args.cpu,
        args.scale, t_start)
    if not args.cpu:
        _diagnose(run)
    found = forbidden_modules()
    if found:
        print(f"portbench: loaded {found} (JAX or the JAX package); "
              f"no result", file=sys.stderr)
        return 3
    correct = check.verdict(numbers, cell.limits)
    compared = check.lines(numbers, cell.limits)
    for k, v in compared.items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    failed = 0 if correct else max(1, int(numbers.get("bad", 0)))
    if args.cpu:
        line = {"rehearsal": "cpu, not a measurement", "correct": correct,
                "attempted": run.ops, "failed": failed,
                "kept_outputs": nkept, "steps": len(run.steps_ns),
                "route_per_op": run.route, "compared": compared}
        print(json.dumps(line))
        return 0
    entries = cell.per_layer if args.trace else cell.end_to_end
    line = {"correct": correct, "attempted": run.ops, "failed": failed,
            "metrics": metrics_of(run, entries), "device": info}
    bd = breakdown(run) if args.trace else None
    if bd is not None:
        line["breakdown"] = bd
    line["route_per_op"] = run.route
    line["compared"] = compared
    sys.stdout.flush()
    print(json.dumps(line))
    return 0
