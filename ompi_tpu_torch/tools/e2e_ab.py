"""End-to-end A/B of checkouts of the port on one card.

    python3 -m ompi_tpu_torch.tools.e2e_ab ROOT [ROOT ...] [--reps 5]
        [--iters 20]

Each ROOT is the root of a checkout that holds ``ompi_tpu_torch/``:
this one (``.``), or another commit unpacked with ``git archive`` into
a directory that .gitignore lists.  For each ROOT, in the order given,
a child process imports ``ompi_tpu_torch`` from that root alone,
builds its kernels and times, at 8 rank threads sharing card 0
(coll/hbm), the collectives whose route depends on the payload size:

- allreduce SUM float32, 8 MiB a rank (the headline) and 2**21 + 3
  elements (a ragged payload);
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
per distinct root.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

NRANKS = 8
MIB = 1 << 20
SEED = 1234
CASES = {  # name -> (collective, float32 elements a rank)
    "allreduce_sum_f32_8MiB": ("allreduce", 2 * MIB),
    "allreduce_sum_f32_ragged_2^21+3": ("allreduce", 2 * MIB + 3),
    "alltoall_f32_8MiB": ("alltoall", 2 * MIB),
    "allreduce_sum_f32_1MiB": ("allreduce", MIB // 4),
    "alltoall_f32_1MiB": ("alltoall", MIB // 4),
}


def _child(root: str, reps: int, iters: int, cpu: bool) -> dict:
    """Runs in a child process whose ompi_tpu_torch comes from root.
    ``cpu``: a rehearsal on the CPU at 1/256 of the sizes."""
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.kernels import build
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

    def measure(kind, n, first):
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

        res = run_ranks(NRANKS, fn, device_map=lambda r: dev, timeout=600)
        return max(dt for dt, _ in res) / iters * 1e6, res[0][1]

    us = {name: [] for name in CASES}
    digests = {}
    for rep in range(reps):
        for name, (kind, n) in CASES.items():
            t, d = measure(kind, n // div + n % div, rep == 0)
            us[name].append(t)
            if d is not None:
                digests[name] = d
    return {"root": root, "us_per_op": us, "digests": digests}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at 1/256 of the sizes")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(_child(a.roots[0], a.reps, a.iters, a.cpu)),
              flush=True)
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
            + (["--cpu"] if a.cpu else []),
            capture_output=True, text=True, timeout=1800)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
            raise RuntimeError(f"child for {root} exited {p.returncode}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    ok = True
    for name in CASES:
        if len({r["digests"][name] for r in runs}) != 1:
            print(f"[e2e_ab] {name}: the roots' results differ",
                  file=sys.stderr)
            ok = False
    order = list(dict.fromkeys(a.roots))
    for name in CASES:
        med = {root: statistics.median(
            [t for r in runs if r["root"] == root
             for t in r["us_per_op"][name]]) for root in order}
        print(f"[e2e_ab] {name}: median us/op "
              + ", ".join(f"{root} {med[root]:.1f}" for root in order),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
