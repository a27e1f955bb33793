"""End-to-end A/B of checkouts of the port on one card.

    python3 -m ompi_tpu_torch.tools.e2e_ab ROOT [ROOT ...] [--reps 5]
        [--iters 20] [--trace | --rma-numpy]

Each ROOT is the root of a checkout that holds ``ompi_tpu_torch/``:
this one (``.``), or another commit unpacked with ``git archive`` into
a directory that .gitignore lists.  For each ROOT, in the order given,
a child process imports ``ompi_tpu_torch`` from that root alone,
builds its kernels and times, at 8 rank threads sharing card 0
(coll/hbm), the collectives whose route depends on the payload size:

- allreduce SUM float32, 8 MiB a rank (the headline; also with
  coll_plan_enable 0, as 8 pipelined segments) and 2**21 + 3 elements
  (a ragged payload);
- alltoall float32, 8 MiB a rank;
- allreduce SUM and alltoall float32, 1 MiB a rank — below the
  large-message crossover, so every checkout runs them the same way,
  which shows the drift and spread of the host clock.

A measurement is the host clock around ``iters`` chained calls (each
rank feeds its output back in) ending in ``torch.cuda.synchronize()``,
the slowest rank's time divided by ``iters``; each case is measured
``reps`` times, the cases interleaved.  Give the roots as A B B A so
that a drift over the run shows as such.  Every root must return the
same bytes for each case's first call, or the tool exits non-zero.

Prints the card's name and power limit, one JSON line per root with
every measurement (µs an op), and a summary: the median of each case
per distinct root.  ``--trace`` runs every measurement with the span
tracer and the phase profiler on (full fidelity, dumps under
``build/trace/ab/`` of this checkout) and adds, per case, the median
µs of the rendezvous-wait phase (``ph_rdv_wait``) over every rank's
waits, and its sum a call (a rank's waits in one call, averaged over
the ranks and calls), to each root's line and the summary; a root
whose package has no tracer cannot be traced.

``--rma-numpy`` times the device window's host-buffer path in place of
the collectives: 2 ranks on 2 logical devices of card 0, rank 0 puts a
seeded numpy array to rank 1 (and gets it back into a numpy array)
under a shared lock, ``iters`` ops closed by one flush, at 8 B, 64 KiB,
1 MiB and 4 MiB, with ``osc_device_dma`` 1 and 0: the ladder a new
way of moving the window's numpy buffers (pinned stages, say) has to
beat.  The bytes each get returns must be the same in every root.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

NRANKS = 8
MIB = 1 << 20
SEED = 1234
CASES = {  # name -> (collective, float32 elements a rank, knobs)
    "allreduce_sum_f32_8MiB": ("allreduce", 2 * MIB, {}),
    "allreduce_sum_f32_8MiB_segments": ("allreduce", 2 * MIB,
                                        {"coll_plan_enable": 0}),
    "allreduce_sum_f32_ragged_2^21+3": ("allreduce", 2 * MIB + 3, {}),
    "alltoall_f32_8MiB": ("alltoall", 2 * MIB, {}),
    "allreduce_sum_f32_1MiB": ("allreduce", MIB // 4, {}),
    "alltoall_f32_1MiB": ("alltoall", MIB // 4, {}),
}
RMA_SIZES = (8, 64 << 10, MIB, 4 * MIB)
RMA_CASES = {  # name -> (op, bytes, osc_device_dma)
    f"{op}_numpy_{nb}B_dma{dma}": (op, nb, dma)
    for dma in (1, 0) for nb in RMA_SIZES for op in ("put", "get")}
TRACE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "build", "trace", "ab")


def _rdv_wait_us(dumps, calls: int):
    """(median µs of one ph_rdv_wait span, µs of waits a rank a call)."""
    waits = [e["dur"] * 1e6 for d in dumps for e in d["events"]
             if e["name"] == "ph_rdv_wait"]
    if not waits:
        raise RuntimeError("no ph_rdv_wait spans in the dumps")
    return statistics.median(waits), sum(waits) / (len(dumps) * calls)


def _child(root: str, reps: int, iters: int, cpu: bool,
           traced: bool, rma: bool) -> dict:
    """Runs in a child process whose ompi_tpu_torch comes from root.
    ``cpu``: a rehearsal on the CPU at 1/256 of the sizes."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.kernels import build
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.op.op import SUM
    from ompi_tpu_torch.testing import run_ranks

    pkg = os.path.dirname(os.path.abspath(ompi_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    if cpu:
        dev, div = torch.device("cpu"), 256
        torch.cuda.synchronize = lambda *a: None
    else:
        build.build_all()
        dev, div = torch.device("cuda", 0), 1
        torch.cuda.set_device(dev)

    def measure(kind, n, first, knobs):
        knobs = dict(knobs)
        if traced:
            out = os.path.join(TRACE_DIR, str(os.getpid()))
            shutil.rmtree(out, ignore_errors=True)
            os.makedirs(out)
            knobs.update(trace_enable=1, trace_phase_enable=1,
                         trace_sample_auto=0, trace_buffer_events=1 << 16,
                         trace_dump_path=out)

        def fn(comm):
            g = torch.Generator(device=dev)
            g.manual_seed(SEED * 100 + comm.rank)
            x = torch.randn(n, generator=g, device=dev)
            call = comm.allreduce_arr if kind == "allreduce" else \
                comm.alltoall_arr
            args = (SUM,) if kind == "allreduce" else ()
            y = call(x, *args)
            digest = None
            if first and comm.rank == 0:
                torch.cuda.synchronize()
                digest = hashlib.sha256(
                    y.cpu().numpy().tobytes()).hexdigest()
            y = x * 1e-6  # chained sums grow 8x a call
            for _ in range(3):
                y = call(y, *args)
            torch.cuda.synchronize()
            comm.Barrier()
            t0 = time.perf_counter()
            for _ in range(iters):
                y = call(y, *args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            comm.Barrier()
            if not torch.isfinite(y).all():
                raise AssertionError(f"{kind} went non-finite")
            return dt, digest

        saved = {k: registry.get(k) for k in knobs}
        try:
            for k, v in knobs.items():
                registry.set(k, v)
            res = run_ranks(NRANKS, fn, device_map=lambda r: dev,
                            timeout=600)
        finally:
            for k, v in saved.items():
                registry.set(k, v)
        rdv = None
        if traced:
            dumps = []
            for f in sorted(glob.glob(os.path.join(out, "trace-r*.json"))):
                with open(f) as fh:
                    dumps.append(json.load(fh))
            rdv = _rdv_wait_us(dumps, iters + 4)
        return max(dt for dt, _ in res) / iters * 1e6, res[0][1], rdv

    def measure_rma(op, nb, dma, first):
        import numpy as np

        from ompi_tpu_torch import osc
        from ompi_tpu_torch.osc import device as _  # noqa: F401
        from ompi_tpu_torch.testing import logical_devices

        def fn(comm):
            win = osc.allocate(comm, nb, name="ab")
            dt = digest = None
            if comm.rank == 0:
                data = np.random.default_rng(SEED + nb).integers(
                    0, 256, nb, dtype=np.uint8)
                back = np.empty(nb, dtype=np.uint8)
                win.lock(1, osc.LOCK_SHARED)
                for _ in range(2):
                    win.put(data, 1)
                    win.get(back, 1)
                    win.flush(1)
                t0 = time.perf_counter()
                for _ in range(iters):
                    if op == "put":
                        win.put(data, 1)
                    else:
                        win.get(back, 1)
                win.flush(1)
                dt = time.perf_counter() - t0
                win.unlock(1)
                if back.tobytes() != data.tobytes():
                    raise AssertionError(f"{nb} B round trip corrupt")
                if first:
                    digest = hashlib.sha256(back.tobytes()).hexdigest()
            comm.Barrier()
            win.free()
            return dt, digest

        saved = registry.get("osc_device_dma")
        registry.set("osc_device_dma", dma)
        try:
            res = run_ranks(2, fn, device_map=logical_devices(dev),
                            timeout=600)
        finally:
            registry.set("osc_device_dma", saved)
        return res[0][0] / iters * 1e6, res[0][1], None

    cases = RMA_CASES if rma else CASES
    us = {name: [] for name in cases}
    rdv = {name: [] for name in cases}
    digests = {}
    for rep in range(reps):
        for name in cases:
            if rma:
                op, nb, dma = cases[name]
                t, d, w = measure_rma(op, max(1, nb // div), dma, rep == 0)
                us[name].append(t)
                if d is not None:
                    digests[name] = d
                continue
            kind, n, knobs = CASES[name]
            t, d, w = measure(kind, n // div + n % div, rep == 0, knobs)
            us[name].append(t)
            if w is not None:
                rdv[name].append(w)
            if d is not None:
                digests[name] = d
    out = {"root": root, "us_per_op": us, "digests": digests}
    if traced:
        out["rdv_wait_us"] = rdv
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at 1/256 of the sizes")
    ap.add_argument("--trace", action="store_true",
                    help="trace every measurement; report ph_rdv_wait")
    ap.add_argument("--rma-numpy", action="store_true",
                    help="time the device window's numpy-buffer puts "
                         "and gets in place of the collectives")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.trace and a.rma_numpy:
        ap.error("--trace and --rma-numpy exclude each other")
    if a.child:
        print(json.dumps(_child(a.roots[0], a.reps, a.iters, a.cpu,
                                a.trace, a.rma_numpy)), flush=True)
        return 0
    if not a.cpu:
        import torch
        if not torch.cuda.is_available():
            print("e2e_ab: no CUDA card available", file=sys.stderr)
            return 2
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        print(f"[card] {card}", flush=True)
    runs = []
    for root in a.roots:
        # run this file by path, so the child imports no ompi_tpu_torch
        # but the one under root
        p = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child",
             "--reps", str(a.reps), "--iters", str(a.iters), root]
            + (["--cpu"] if a.cpu else [])
            + (["--trace"] if a.trace else [])
            + (["--rma-numpy"] if a.rma_numpy else []),
            capture_output=True, text=True, timeout=1800)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
            raise RuntimeError(f"child for {root} exited {p.returncode}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    ok = True
    cases = list(runs[0]["us_per_op"])
    for name in cases:
        if len({r["digests"][name] for r in runs}) != 1:
            print(f"[e2e_ab] {name}: the roots' results differ",
                  file=sys.stderr)
            ok = False
    order = list(dict.fromkeys(a.roots))
    for name in cases:
        med = {root: statistics.median(
            [t for r in runs if r["root"] == root
             for t in r["us_per_op"][name]]) for root in order}
        print(f"[e2e_ab] {name}: median us/op "
              + ", ".join(f"{root} {med[root]:.1f}" for root in order),
              flush=True)
        if a.trace:
            waits = {root: [w for r in runs if r["root"] == root
                            for w in r["rdv_wait_us"][name]]
                     for root in order}
            print(f"[e2e_ab] {name}: ph_rdv_wait, median us a wait / us "
                  "a rank a call, median of the measurements: " + ", ".join(
                      f"{root} {statistics.median(w[0] for w in ws):.1f}"
                      f" / {statistics.median(w[1] for w in ws):.1f}"
                      for root, ws in waits.items()), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
