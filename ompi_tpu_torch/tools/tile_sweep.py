"""Tile and size sweep of K6 mesh_fold, K2 stacked_copy, K7 slot_pack,
K8 rma_copy, K9 rma_acc, K11 digest and K5 index_scatter on one card.

    python3 -m ompi_tpu_torch.tools.tile_sweep [--iters 50]
        [--kernels K6,K2,K7,K8,K9,K11,K5]

K6 and K2 walk flat tile lists through a ring of shared-memory stages
(kernels/csrc/mesh.cu, stacked.cu), sized by the wrappers' knobs
(``mesh.FOLD_TILE`` / ``mesh.FOLD_STAGES``, ``stacked.COPY_TILE`` /
``stacked.COPY_STAGES``), set for each point of their grids below.  K7
gives each block a span of ``PACK_UNITS`` 16-byte units of one slot and
each thread ``PACK_U`` units it loads before it stores (mesh.cu); K9
gives each thread ``ACC_U`` vectors of w and s it loads before it
stores, K8 ``COPY_U`` consecutive destination words (rma.cu); K11
gives each thread ``DIGEST_U`` 16-byte groups a round (digest.cu,
mirrored as ``digest.U``, which fixes the block count); K5 gives each
thread at most ``SCATTER_ELEMS`` packed elements in blocks of
``SCATTER_THREADS`` threads and holds a run table of ``SCATTER_RUNS``
runs in its launch arguments (index.cu; mirrored as
``index.MAX_RUNS``).  Those are constants of their
sources: for each point of K7's, K8's, K9's, K11's and K5's grids a
copy of the library is built with ``-D`` (into
``build/ompi_tpu_torch/sweep/``, one nvcc a copy, all started
together) and loaded in place of the checkout's.  Each kernel
is timed at the main path's shapes, 8 members on one card (one grouped
launch a call):

- K6: the fused mesh batch's fold (8 x 2 MiB, rank order), the 8 MiB
  allreduce's fold in rank order and in the segring order, and one
  1 MiB stripe of 8 inputs;
- K2: the 1 MiB alltoall (peer mode), the 8 MiB allreduce's gather of
  stripes (peer mode), one member's neighbour gather on the 2x4
  periodic grid at 8 MiB (peer mode), and the stacked allgather and
  alltoall of 1 MiB a rank (coll/hbm);
- K7: one rank's 32 slots of 64 KiB float32 (the fused flush), and the
  ragged mix of 32 slots of 64 KiB + 20 B;
- K8: a 64 MiB put, aligned and at byte skews 1 and 4;
- K9: a 64 MiB float32 SUM accumulate, plain, fetch and at target_disp
  1 (w 4 bytes off 16), and the main path's 8 int32;
- K11: a gate's FSUM over 8 MiB and 128 MiB of float32 and over the
  8 MiB operand 4 bytes into its buffer, INTSUM over 8 MiB of int32
  and of uint8, MAX over 8 MiB of float32, a table of 8 x 1 MiB int32;
- K5: config 5's unpack of 2**17 float64 into a stride-2 span and of
  the whole 2**20-element result (run mode), and 2**17 random
  destinations in a 2**18 span (index mode).

A time is the device's: CUDA events around a replayed CUDA graph of
``iters`` calls, divided by ``iters``, cold (the calls rotate through
input sets that move at least 256 MiB a replay, five times the L2; the
8-element row uses one set).  Every configuration's first output is
held against the plain version (exact; a float SUM digest within 1e-12
relative, since the plain version sums in another order).  Prints the card's name and
power limit, one line a (kernel, case, configuration), and the
configuration with the least summed time for each kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess

import torch

MIB = 1 << 20
COLD = 256 * MIB
N = 8
RING = 192 * 1024  # a ring's bytes at most (a stage: N slices for K6)
FOLD_GRID = [(t, s) for t in (1024, 2048, 4096) for s in (2, 3, 4)]
COPY_GRID = [(t, s) for t in (8192, 16384, 32768) for s in (2, 4, 8)
             if t * s <= RING]
PACK_GRID = [(n, u) for n in (256, 512, 1024) for u in (2, 4, 8)]
ACC_GRID = [(1,), (2,), (4,)]
RMA_COPY_GRID = [(1,), (2,), (4,)]
DIGEST_GRID = [(1,), (2,), (4,), (8,)]
SCATTER_GRID = [(e, t, r) for e in (2, 4, 8) for t in (128, 256, 512)
                for r in (4, 64)]
# a constant of a source that its wrapper module mirrors
MIRRORS = {"PACK_UNITS": "UNITS", "DIGEST_U": "U",
           "SCATTER_RUNS": "MAX_RUNS"}


def _variants(jobs):
    """Build each (source name, knobs, point) of ``jobs``: the source
    compiled with -D<knob>=<value>, one nvcc a job, all started
    together.  Returns {(name, knobs, point): library path}."""
    from ompi_tpu_torch.kernels import build
    out_dir = os.path.join(build.BUILD_DIR, "sweep")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, knobs, point in jobs:
        tag = "-".join(f"{k}{v}" for k, v in zip(knobs, point))
        lib = os.path.join(out_dir, f"lib{name}-{tag}.so")
        procs[name, knobs, point] = lib, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS,
             *[f"-D{k}={v}" for k, v in zip(knobs, point)], "-o", lib,
             os.path.join(build.CSRC, build.SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for key, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        libs[key] = lib
    return libs


def _defaults(name, knobs):
    """The values of ``knobs`` that the checkout's source defines."""
    from ompi_tpu_torch.kernels import build
    with open(os.path.join(build.CSRC, build.SOURCES[name])) as fh:
        text = fh.read()
    return tuple(int(re.search(rf"#define {k} (\d+)", text).group(1))
                 for k in knobs)


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
    from ompi_tpu_torch.kernels import mesh, rma, stacked

    def ranks(nel, salt, count=N):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return [torch.randn(nel, generator=g, device=dev)
                    for _ in range(count)]
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
    nf = 16 * 1024  # 64 KiB of float32
    for name, nel in (("pack_32x64KiB", nf), ("pack_32x(64KiB+20B)", nf + 5)):
        out[name] = ("K7", 2 * 32 * nel * 4, ranks(nel, 14, 32),
                     mesh.slot_pack, mesh.slot_pack_plain)
    out.update(_acc_cases(dev, rma))
    out.update(_copy_digest_cases(dev, rma))
    out.update(_scatter_cases(dev))
    return out


def _scatter_cases(dev):
    """K5's cases at config 5's shapes, float64: one rank's unpack of
    2**17 elements into a stride-2 span and the whole 2**20-element
    result (run mode), and 2**17 random destinations in a 2**18 span
    (index mode); a set is (packed, IndexVector, out), out written in
    place.  Bytes: packed + span in run mode, index + packed + span in
    index mode, as chip_smoke's rows."""
    import numpy as np
    from ompi_tpu_torch.kernels import index

    def sets(salt, n, idx):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return (torch.randn(n, generator=g, device=dev,
                                dtype=torch.float64),
                    index.IndexVector(idx(i), dev),
                    torch.zeros(2 * n, dtype=torch.float64, device=dev))
        return make

    def run(f):
        return lambda st: f(*st)

    m = 1 << 17
    return {name: ("K5", nb * n, sets(40 + k, n, idx),
                   run(index.index_scatter), run(index.index_scatter_plain))
            for k, (name, n, nb, idx) in enumerate((
                ("unpack_config5_f64_1MiB", m, 24,
                 lambda i: np.arange(0, 2 * m, 2)),
                ("unpack_config5_f64_8MiB", 8 * m, 24,
                 lambda i: np.arange(0, 16 * m, 2)),
                ("perm_f64_1MiB", m, 32,
                 lambda i: np.random.default_rng(i).permutation(
                     2 * m)[:m])))}


def _copy_digest_cases(dev, rma):
    """K8's and K11's cases: (kernel, bytes, make(i), kernel fn, plain
    fn[, compare])."""
    from ompi_tpu_torch.kernels import digest as k11
    nb = 64 * MIB

    def put(salt, skew):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return (torch.empty(nb + 16, dtype=torch.uint8, device=dev),
                    torch.randint(0, 256, (nb,), generator=g, device=dev,
                                  dtype=torch.uint8))
        return make, (lambda st: rma.rma_copy(st[0], skew, st[1], 0, nb)
                      [skew:skew + nb]), \
            (lambda st: rma.rma_copy_plain(st[0], skew, st[1], 0, nb)
             [skew:skew + nb])

    def dig(salt, nel, code, dt=torch.float32, count=1, off=0):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            xs = []
            for _ in range(count):
                b = torch.empty(nel + off, dtype=dt, device=dev)
                b[off:] = torch.randn(nel, generator=g, device=dev) \
                    if dt.is_floating_point else torch.randint(
                        -2 ** 31, 2 ** 31 - 1, (nel,), generator=g,
                        device=dev, dtype=torch.int64).to(dt)
                xs.append(b[off:])
            return xs
        return (make, lambda xs: k11.digest(xs, [code] * len(xs)),
                lambda xs: k11.digest_plain(xs, [code] * len(xs)))

    def close(a, b):  # float64 sums in two orders
        a, b = a.view(torch.float64), b.view(torch.float64)
        return bool(((a - b).abs() <= 1e-12 * torch.maximum(
            a.abs(), b.abs())).all())

    n32 = 8 * MIB // 4
    out = {f"put_64MiB{'' if k == 0 else f'_skew{k}'}":
           ("K8", 2 * nb, *put(30 + k, k)) for k in (0, 1, 4)}
    for name, nbytes, args, cmp in (
            ("gate_fsum_f32_8MiB", 8 * MIB, (31, n32, k11.F_FSUM), close),
            ("gate_fsum_f32_128MiB", 128 * MIB, (32, 16 * n32, k11.F_FSUM),
             close),
            ("gate_fsum_f32_8MiB_off4", 8 * MIB,
             (33, n32, k11.F_FSUM, torch.float32, 1, 1), close),
            ("verify_intsum_i32_8MiB", 8 * MIB,
             (34, n32, k11.F_INTSUM, torch.int32), None),
            ("verify_intsum_u8_8MiB", 8 * MIB,
             (35, 4 * n32, k11.F_INTSUM, torch.uint8), None),
            ("gate_max_f32_8MiB", 8 * MIB, (36, n32, k11.F_MAX), None),
            ("verify_table_8x1MiB_intsum_i32", 8 * MIB,
             (37, n32 // 8, k11.F_INTSUM, torch.int32, 8), None)):
        out[name] = ("K11", nbytes, *dig(*args)) + ((cmp,) if cmp else ())
    return out


def _acc_cases(dev, rma):
    """K9's cases: (kernel, bytes, make(i), kernel fn, plain fn); a set
    is (w bytes, s, old or None, start), w and old written in place."""
    nb = 64 * MIB

    def acc_set(salt, start, fetch, nel=nb // 4, dt=torch.float32):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            if dt == torch.float32:
                w, s = (torch.randn(nel, generator=g, device=dev)
                        for _ in range(2))
            else:
                w, s = (torch.randint(-99, 99, (nel,), generator=g,
                                      device=dev, dtype=dt)
                        for _ in range(2))
            w = torch.cat([torch.zeros(start, dtype=torch.uint8, device=dev),
                           w.view(torch.uint8)])
            old = torch.empty(nel, dtype=dt, device=dev) if fetch else None
            return w, s, old, start
        return make

    def run(f):
        def fn(st):
            w, s, old, start = st
            f(w, start, s, "MPI_SUM", old)
            out = [w[start:].view(s.dtype)]
            return out + ([old] if old is not None else [])
        return fn

    return {name: ("K9", nbytes, make, run(rma.rma_acc),
                   run(rma.rma_acc_plain))
            for name, nbytes, make in (
                ("acc_sum_f32_64MiB", 3 * nb, acc_set(20, 0, False)),
                ("acc_fetch_sum_f32_64MiB", 4 * nb, acc_set(21, 0, True)),
                ("acc_sum_f32_64MiB_disp1", 3 * nb, acc_set(22, 4, False)),
                ("acc_sum_i32_8elem", 96, acc_set(23, 0, False, 8,
                                                   torch.int32)))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--kernels", default="K6,K2,K7,K8,K9,K11,K5",
                    help="the kernels to sweep, comma-separated")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tile_sweep: no CUDA card")
    from ompi_tpu_torch.kernels import build, index, mesh, rma, stacked
    from ompi_tpu_torch.kernels import digest as k11
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    grids = {"K6": (FOLD_GRID, ("FOLD_TILE", "FOLD_STAGES"), mesh, None),
             "K2": (COPY_GRID, ("COPY_TILE", "COPY_STAGES"), stacked, None),
             "K7": (PACK_GRID, ("PACK_UNITS", "PACK_U"), mesh, "mesh"),
             "K8": (RMA_COPY_GRID, ("COPY_U",), rma, "rma"),
             "K9": (ACC_GRID, ("ACC_U",), rma, "rma"),
             "K11": (DIGEST_GRID, ("DIGEST_U",), k11, "digest"),
             "K5": (SCATTER_GRID, ("SCATTER_ELEMS", "SCATTER_THREADS",
                                   "SCATTER_RUNS"), index, "index")}
    kernels = args.kernels.split(",")
    build.build_all(["stacked", "mesh", "rma", "digest", "index"])
    libs = _variants(list(dict.fromkeys(
        (grids[k][3], grids[k][1], point) for k in kernels if grids[k][3]
        for point in grids[k][0])))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    cases = _cases(dev)
    for kernel in kernels:
        grid, knobs, mod, source = grids[kernel]
        saved = _defaults(source, knobs) if source else \
            tuple(getattr(mod, k) for k in knobs)

        def use(point):
            """Set the module's knobs (or the mirrors of the source's
            constants) to ``point``."""
            for k, v in zip(knobs, point):
                if not source:
                    setattr(mod, k, v)
                elif k in MIRRORS:
                    setattr(mod, MIRRORS[k], v)
        totals = {}
        for point in grid:
            conf = ", ".join(f"{k} {v}" for k, v in zip(knobs, point))
            use(point)
            if source:
                build._libs[source] = ctypes.CDLL(libs[source, knobs, point])
                mod._lib = None  # the wrapper binds the copy at its call
            total = 0.0
            for name, (kk, nbytes, make, k_fn, p_fn, *cmp) in cases.items():
                if kk != kernel:
                    continue
                same = cmp[0] if cmp else torch.equal
                got, want = k_fn(make(0)), p_fn(make(0))
                got = got if isinstance(got, list) else [got]
                want = want if isinstance(want, list) else [want]
                if not all(same(a, b) for a, b in zip(got, want)):
                    raise AssertionError(f"{kernel} {name} {conf}: differs")
                del got, want
                sets = [make(i) for i in range(max(1, -(-COLD // nbytes))
                                               if nbytes > MIB else 1)]
                ms = _time(k_fn, sets, max(args.iters, len(sets)))
                total += ms
                print(f"[sweep] {kernel} {name}: {conf}: {ms:.4f} ms "
                      f"(bound {nbytes / 3.35e12 * 1e3:.4f} ms)", flush=True)
                del sets
            totals[point] = total
        use(saved)
        if source:  # back to the checkout's library
            del build._libs[source]
            mod._lib = None
        best = min(totals, key=totals.get)
        print(f"[sweep] {kernel} best: "
              + ", ".join(f"{k} {v}" for k, v in zip(knobs, best))
              + f" ({totals[best]:.4f} ms summed; now "
              + ", ".join(f"{k} {v}" for k, v in zip(knobs, saved))
              + f": {totals.get(saved, float('nan')):.4f}) [{card}]",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
