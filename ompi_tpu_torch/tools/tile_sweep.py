"""Tile and ring sweep of K6 mesh_fold and K2 stacked_copy on one card.

    python3 -m ompi_tpu_torch.tools.tile_sweep [--iters 50]

K6 and K2 walk flat tile lists through a ring of shared-memory stages
(kernels/csrc/mesh.cu, stacked.cu).  For each (tile, stages) pair of
the grids below, the wrappers' knobs (``mesh.FOLD_TILE`` /
``mesh.FOLD_STAGES``, ``stacked.COPY_TILE`` / ``stacked.COPY_STAGES``)
are set and each kernel is timed at the mesh tier's main-path shapes,
8 members on one card (one grouped launch a call):

- K6: the fused mesh batch's fold (8 x 2 MiB, rank order), the 8 MiB
  allreduce's fold in rank order and in the segring order, and one
  1 MiB stripe of 8 inputs;
- K2: the 1 MiB alltoall (peer mode), the 8 MiB allreduce's gather of
  stripes (peer mode), one member's neighbour gather on the 2x4
  periodic grid at 8 MiB (peer mode), and the stacked allgather and
  alltoall of 1 MiB a rank (coll/hbm).

A time is the device's: CUDA events around a replayed CUDA graph of
``iters`` calls, divided by ``iters``, cold (the calls rotate through
input sets that move at least 256 MiB a replay, five times the L2).
Every configuration's first output is held against the plain version
(exact).  Prints the card's name and power limit, one line a (kernel,
case, tile, stages), and the pair with the least summed time for each
kernel.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

MIB = 1 << 20
COLD = 256 * MIB
N = 8
RING = 192 * 1024  # a ring's bytes at most (a stage: N slices for K6)
FOLD_GRID = [(t, s) for t in (1024, 2048, 4096) for s in (2, 3, 4)]
COPY_GRID = [(t, s) for t in (8192, 16384, 32768) for s in (2, 4, 8)
             if t * s <= RING]


def _time(fn, sets, iters: int) -> float:
    for i in range(3):
        fn(sets[i % len(sets)])
    torch.cuda.synchronize()
    keep = []
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            keep.append(fn(sets[i % len(sets)]))
    g.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _cases(dev):
    """name -> (kernel, bytes moved, make(i), kernel fn, plain fn)."""
    from ompi_tpu_torch.coll.device import _stripe_elems
    from ompi_tpu_torch.kernels import mesh, stacked

    def ranks(nel, salt):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return [torch.randn(nel, generator=g, device=dev)
                    for _ in range(N)]
        return make

    def folds(nel, order):
        st = _stripe_elems(nel, N, 4)

        def jobs():
            return [(torch.empty(min(st, nel - d * st), device=dev), d * st)
                    for d in range(N) if d * st < nel]
        return (lambda xs: mesh.mesh_fold_many(xs, jobs(), "MPI_SUM", order),
                lambda xs: mesh.mesh_fold_many_plain(xs, jobs(), "MPI_SUM",
                                                     order))

    n8, n2, n1 = 2 * MIB, MIB // 2, MIB // 4
    ring = ("ring", MIB // 4, MIB // 4 // N)
    ms = _stripe_elems(n8, N, 4)
    b1 = n1 // N
    out = {}
    for name, nel, order in (("fused_8x2MiB", n2, "rank"),
                             ("allreduce_8MiB_rank", n8, "rank"),
                             ("allreduce_8MiB_segring", n8, ring)):
        out[name] = ("K6", (N + 1) * nel * 4, ranks(nel, len(out)),
                     *folds(nel, order))
    out["one_stripe_1MiB"] = (
        "K6", (N + 1) * n1 * 4, ranks(n1, 9),
        lambda xs: mesh.mesh_fold(xs, torch.empty(n1, device=dev), 0,
                                  "MPI_SUM"),
        lambda xs: mesh.mesh_fold_plain(xs, 0, n1, "MPI_SUM"))
    out["peer_alltoall_1MiB"] = (
        "K2", 2 * N * n1 * 4, ranks(n1, 10),
        lambda xs: stacked.peer_copy_many(
            xs, [torch.empty(n1, device=dev) for _ in range(N)], b1,
            src_stride=b1),
        lambda xs: stacked.peer_copy_many_plain(
            xs, [torch.empty(n1, device=dev) for _ in range(N)], b1,
            src_stride=b1))
    out["peer_gather_stripes_8MiB"] = (
        "K2", (N + 1) * n8 * 4, ranks(ms, 11),
        lambda st: stacked.peer_copy_many(
            st, [torch.empty(n8, device=dev) for _ in range(N)], ms,
            limit=n8),
        lambda st: stacked.peer_copy_many_plain(
            st, [torch.empty(n8, device=dev) for _ in range(N)], ms,
            limit=n8))
    nbrs = [4, 4, 3, 1]  # member 0 of the 2x4 periodic grid
    out["peer_neighbor_gather_8MiB"] = (
        "K2", (3 + 4) * n8 * 4, ranks(n8, 13),
        lambda xs: stacked.peer_copy([xs[s] for s in nbrs],
                                     torch.empty(4 * n8, device=dev), n8),
        lambda xs: stacked.peer_copy_plain([xs[s] for s in nbrs],
                                           torch.empty(4 * n8, device=dev),
                                           n8))
    for kind in ("allgather", "alltoall"):
        nb = (N + N * N) * n1 * 4 if kind == "allgather" else 2 * N * n1 * 4
        out[f"stacked_{kind}_1MiB"] = (
            "K2", nb, ranks(n1, 12),
            lambda xs, kind=kind: stacked.stacked_copy(xs, kind),
            lambda xs, kind=kind: stacked.stacked_copy_plain(xs, kind))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: no CUDA card")
    from ompi_tpu_torch.kernels import build, mesh, stacked
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build_all(["stacked", "mesh"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    cases = _cases(dev)
    grids = {"K6": (FOLD_GRID, ("FOLD_TILE", "FOLD_STAGES"), mesh),
             "K2": (COPY_GRID, ("COPY_TILE", "COPY_STAGES"), stacked)}
    for kernel, (grid, (tk, sk), mod) in grids.items():
        saved = getattr(mod, tk), getattr(mod, sk)
        totals = {}
        for tile, stages in grid:
            setattr(mod, tk, tile)
            setattr(mod, sk, stages)
            total = 0.0
            for name, (kk, nbytes, make, k_fn, p_fn) in cases.items():
                if kk != kernel:
                    continue
                sets = [make(i) for i in range(max(1, -(-COLD // nbytes)))]
                got, want = k_fn(sets[0]), p_fn(sets[0])
                got = got if isinstance(got, list) else [got]
                want = want if isinstance(want, list) else [want]
                if not all(torch.equal(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{kernel} {name} tile {tile} "
                                         f"stages {stages}: differs")
                ms = _time(k_fn, sets, max(args.iters, len(sets)))
                total += ms
                print(f"[sweep] {kernel} {name}: tile {tile} B, {stages} "
                      f"stages: {ms:.4f} ms (bound "
                      f"{nbytes / 3.35e12 * 1e3:.4f} ms)", flush=True)
                del sets
            totals[(tile, stages)] = total
        setattr(mod, tk, saved[0])
        setattr(mod, sk, saved[1])
        best = min(totals, key=totals.get)
        print(f"[sweep] {kernel} best: tile {best[0]} B, {best[1]} stages "
              f"({totals[best]:.4f} ms summed; now {saved[0]} B, "
              f"{saved[1]} stages: {totals.get(saved, float('nan')):.4f}) "
              f"[{card}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
