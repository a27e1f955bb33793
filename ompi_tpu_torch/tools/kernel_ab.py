"""Device-time A/B of K6 mesh_fold, K2 stacked_copy, K7 slot_pack, K8
rma_copy, K9 rma_acc, K10 rma_cas, K11 digest, K4 index_gather and K5
index_scatter across checkouts.

    python3 -m ompi_tpu_torch.tools.kernel_ab ROOT [ROOT ...]
        [--iters 50] [--kernels K4,K5] [--cpu]

Each ROOT is the root of a checkout that holds ``ompi_tpu_torch/``:
this one (``.``), or another commit unpacked with ``git archive`` into
a directory that .gitignore lists.  For each ROOT, in the order given,
a child process imports ``ompi_tpu_torch`` from that root alone,
builds its kernels and times the launches that the mesh tier, coll/hbm
and the device window make for one collective or op, at the main
path's shapes (8 members on one card):

- K6: the fused mesh batch's fold (8 x 2 MiB), the 8 MiB allreduce's
  fold in rank order and in the segring order, the 128 MiB plan's
  fold, and one 1 MiB stripe of 8 inputs;
- K2: the 8 MiB allreduce's gather of stripes, the 1 MiB alltoall,
  8 stripes of 1 MiB into one output (peer mode), one member's
  neighbour gather on the 2x4 periodic grid at 8 MiB, and the stacked
  allgather and alltoall of 1 MiB a rank;
- K7: one rank's pack of the fused flush (32 slots of 64 KiB float32)
  and the ragged mix (32 slots of 64 KiB + 20 B, so that the packed
  offsets skew from the sources by 4, 8 and 12 bytes);
- K9: a 64 MiB float32 SUM accumulate, plain, fetch (``old`` written)
  and at target_disp 1 (w 4 bytes off 16, s aligned), 64 MiB uint8 and
  int16 SUM accumulates (every operand 16-byte aligned), and the main
  path's accumulate of 8 int32 (one input set: bound by its launch;
  four times the calls a graph);
- K8: a 64 MiB put into a shard, aligned and at byte skews 1 and 4
  (dst 1 and 4 bytes into the shard, src aligned);
- K10: one int64 compare-and-swap (one input set, launch-bound);
- K11: a gate's FSUM over 8 MiB and 128 MiB of float32, the 8 MiB
  float32 operand 4 bytes into its buffer, a verify's INTSUM over 8
  MiB of int32 and of uint8, MAX over 8 MiB of float32, and a verify's
  table of 8 int32 operands of 1 MiB;
- K4: config 5's pack, the even elements of 2**21 float64;
- K5: config 5's unpack of one rank's 2**17 float64 into a stride-2
  span and of the whole 2**20-element result, and 2**17 random
  destinations in a 2**18 span (index mode where the root has modes).

A checkout whose wrappers take a destination table
(``mesh.mesh_fold_many``, ``stacked.peer_copy_many``) makes one call
of it, as its tier does; an older one makes one call a destination
(``mesh_fold``, ``peer_copy``), as its tier did.  A time is the
device's: CUDA events around a replayed CUDA graph of ``iters`` calls,
divided by ``iters``, cold (input sets that move at least 256 MiB a
replay).  Give the roots as A B B A.  Every root must write the same
bytes for each row (a float SUM digest, whose bits follow each
checkout's fold order: the same value within 1e-9 relative), or the
tool exits non-zero.  Prints the card's
name and power limit, one JSON line a root, and the median of each
row per distinct root.  ``--cpu`` rehearses the control flow on the
CPU with the plain versions, at 1/64 of the sizes, without timing.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

MIB = 1 << 20
COLD = 256 * MIB
N = 8


def _child(root: str, iters: int, cpu: bool, only=()) -> dict:
    """Runs in a child process whose ompi_tpu_torch comes from root."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import ompi_tpu_torch
    from ompi_tpu_torch.coll.device import _stripe_elems
    from ompi_tpu_torch.kernels import build, index, mesh, rma, stacked
    from ompi_tpu_torch.kernels import digest as k11

    pkg = os.path.dirname(os.path.abspath(ompi_tpu_torch.__file__))
    if os.path.dirname(pkg) != os.path.abspath(root):
        raise RuntimeError(f"imported {pkg}, not the one under {root}")
    div = 64 if cpu else 1
    if cpu:
        dev = torch.device("cpu")
    else:
        build.build_all(["stacked", "mesh", "rma", "digest", "index"])
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    grouped = hasattr(mesh, "mesh_fold_many")

    def fold(xs, jobs, order="rank"):
        if grouped:
            return mesh.mesh_fold_many(xs, jobs, "MPI_SUM", order)
        return [mesh.mesh_fold(xs, o, lo, "MPI_SUM", order) for o, lo in jobs]

    def copy(srcs, outs, block, **kw):
        if grouped:
            return stacked.peer_copy_many(srcs, outs, block, **kw)
        return [stacked.peer_copy(srcs, o, block, dst=d, **kw)
                for d, o in enumerate(outs)]

    def ranks(nel, salt, count=N):
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return [torch.randn(nel, generator=g, device=dev)
                    for _ in range(count)]
        return make

    def folds(nel, order):
        st = _stripe_elems(nel, N, 4)
        return lambda xs: fold(xs, [
            (torch.empty(min(st, nel - d * st), device=dev), d * st)
            for d in range(N) if d * st < nel], order)

    def empties(nel, count):
        return [torch.empty(nel, device=dev) for _ in range(count)]

    n1, n2, n8, n128 = (x // div for x in (MIB // 4, MIB // 2, 2 * MIB,
                                           32 * MIB))
    ms = _stripe_elems(n8, N, 4)
    b1 = n1 // N
    seg = MIB // 4 // div
    nbrs = [4, 4, 3, 1]  # member 0 of the 2x4 periodic grid
    nf, nb = 16 * 1024, 64 * MIB // div  # a 64 KiB slot; a 64 MiB op

    def acc(salt, start, fetch, nel=nb // 4, dt=torch.float32):
        """K9's input sets (w bytes, s, old or None) and its call: w's
        elements sit ``start`` bytes into the shard's bytes."""
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            if dt.is_floating_point:
                w, s = (torch.randn(nel, generator=g, device=dev, dtype=dt)
                        for _ in range(2))
            else:
                w, s = (torch.randint(0, 99, (nel,), generator=g,
                                      device=dev, dtype=dt)
                        for _ in range(2))
            w = torch.cat([torch.zeros(start, dtype=torch.uint8, device=dev),
                           w.view(torch.uint8)])
            return w, s, torch.empty(nel, dtype=dt, device=dev) \
                if fetch else None

        def fn(st):
            w, s, old = st
            rma.rma_acc(w, start, s, "MPI_SUM", old)
            return [w] + ([old] if old is not None else [])
        return make, fn

    def put(salt, skew):
        """K8's input sets (dst shard, src) and its put at dst + skew."""
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return (torch.empty(nb + 16, dtype=torch.uint8, device=dev),
                    torch.randint(0, 256, (nb,), generator=g, device=dev,
                                  dtype=torch.uint8))
        return make, lambda st: rma.rma_copy(st[0], skew, st[1], 0,
                                             nb)[skew:skew + nb]

    def cas(i):
        return (torch.zeros(16, dtype=torch.uint8, device=dev),
                torch.zeros(1, dtype=torch.int64, device=dev),
                torch.full((1,), 7, dtype=torch.int64, device=dev),
                torch.empty(1, dtype=torch.int64, device=dev))

    def dig(salt, nel, code, dt=torch.float32, count=1, off=0):
        """K11's input sets (``count`` operands of nel elements, each
        ``off`` elements into its buffer) and its one table launch."""
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
        return make, lambda xs: k11.digest(xs, [code] * len(xs))

    def scatter(salt, m, span, idx):
        """K5's input sets (packed, IndexVector, out) and its call; the
        index vector made anew a set, as config 5's device_unpack finds
        it: written long before."""
        def make(i):
            g = torch.Generator(device=dev)
            g.manual_seed(1000 * salt + i)
            return (torch.randn(m, generator=g, device=dev,
                                dtype=torch.float64),
                    index.IndexVector(idx(i), dev),
                    torch.zeros(span, dtype=torch.float64, device=dev))
        return make, lambda st: index.index_scatter(*st)

    def pack(i):
        g = torch.Generator(device=dev)
        g.manual_seed(1000 * 34 + i)
        return (torch.randn(2 * c5, generator=g, device=dev,
                            dtype=torch.float64),
                index.IndexVector(np.arange(0, 2 * c5, 2), dev))

    c5, m5 = (1 << 20) // div, (1 << 17) // div  # config 5's elements
    n32 = 8 * MIB // 4 // div
    rows = {  # name -> (bytes moved, make(i), fn[, input sets])
        "K6 fused_8x2MiB": ((N + 1) * n2 * 4, ranks(n2, 1), folds(n2, "rank")),
        "K6 allreduce_8MiB_rank": ((N + 1) * n8 * 4, ranks(n8, 2),
                                   folds(n8, "rank")),
        "K6 allreduce_8MiB_segring": (
            (N + 1) * n8 * 4, ranks(n8, 3),
            folds(n8, ("ring", seg, seg // N))),
        "K6 plan_128MiB": ((N + 1) * n128 * 4, ranks(n128, 4),
                           folds(n128, "rank")),
        "K6 one_stripe_1MiB": (
            (N + 1) * n1 * 4, ranks(n1, 5),
            lambda xs: fold(xs, [(torch.empty(n1, device=dev), 0)])),
        "K2 gather_stripes_8MiB": (
            (N + 1) * n8 * 4, ranks(ms, 6),
            lambda st: copy(st, empties(n8, N), ms, limit=n8)),
        "K2 alltoall_1MiB": (
            2 * N * n1 * 4, ranks(n1, 7),
            lambda xs: copy(xs, empties(n1, N), b1, src_stride=b1)),
        "K2 gather_8_stripes_one_output_1MiB": (
            2 * N * n1 * 4, ranks(n1, 8),
            lambda st: copy(st, empties(N * n1, 1), n1)),
        "K2 neighbor_gather_8MiB": (
            7 * n8 * 4, ranks(n8, 9),
            lambda xs: stacked.peer_copy([xs[s] for s in nbrs],
                                         torch.empty(4 * n8, device=dev),
                                         n8)),
        "K2 stacked_allgather_1MiB": (
            (N + N * N) * n1 * 4, ranks(n1, 10),
            lambda xs: stacked.stacked_copy(xs, "allgather")),
        "K2 stacked_alltoall_1MiB": (
            2 * N * n1 * 4, ranks(n1, 11),
            lambda xs: stacked.stacked_copy(xs, "alltoall")),
        "K7 pack_32x64KiB": (2 * 32 * nf * 4, ranks(nf, 12, 32),
                             mesh.slot_pack),
        "K7 pack_32x(64KiB+20B)": (2 * 32 * (nf + 5) * 4,
                                   ranks(nf + 5, 13, 32), mesh.slot_pack),
        "K9 acc_sum_f32_64MiB": (3 * nb, *acc(14, 0, False)),
        "K9 acc_fetch_sum_f32_64MiB": (4 * nb, *acc(15, 0, True)),
        "K9 acc_sum_f32_64MiB_disp1": (3 * nb, *acc(16, 4, False)),
        "K9 acc_sum_u8_64MiB": (3 * nb, *acc(18, 0, False, nb, torch.uint8)),
        "K9 acc_sum_i16_64MiB": (3 * nb, *acc(19, 0, False, nb // 2,
                                              torch.int16)),
        "K9 acc_sum_i32_8elem": (96, *acc(17, 0, False, 8, torch.int32),
                                 1),
        "K8 put_64MiB": (2 * nb, *put(20, 0)),
        "K8 put_64MiB_skew1": (2 * nb, *put(21, 1)),
        "K8 put_64MiB_skew4": (2 * nb, *put(22, 4)),
        "K10 cas_int64": (40, cas, lambda st: rma.rma_cas(
            st[0], 0, *st[1:]) or [st[0], st[3]], 1),
        "K11 gate_fsum_f32_8MiB": (4 * n32, *dig(23, n32, k11.F_FSUM)),
        "K11 gate_fsum_f32_128MiB": (64 * n32,
                                     *dig(24, 16 * n32, k11.F_FSUM)),
        "K11 gate_fsum_f32_8MiB_off4": (4 * n32,
                                        *dig(25, n32, k11.F_FSUM, off=1)),
        "K11 verify_intsum_i32_8MiB": (4 * n32, *dig(26, n32, k11.F_INTSUM,
                                                     torch.int32)),
        "K11 verify_intsum_u8_8MiB": (4 * n32, *dig(27, 4 * n32,
                                                    k11.F_INTSUM,
                                                    torch.uint8)),
        "K11 gate_max_f32_8MiB": (4 * n32, *dig(28, n32, k11.F_MAX)),
        "K11 verify_table_8x1MiB_intsum_i32": (
            4 * n32, *dig(29, n32 // 8, k11.F_INTSUM, torch.int32, 8)),
        "K4 pack_config5_f64_8MiB": (32 * c5, pack,
                                     lambda st: index.index_gather(*st)),
        "K5 unpack_config5_f64_1MiB": (24 * m5, *scatter(
            30, m5, 2 * m5, lambda i: np.arange(0, 2 * m5, 2))),
        "K5 unpack_config5_f64_8MiB": (24 * c5, *scatter(
            31, c5, 2 * c5, lambda i: np.arange(0, 2 * c5, 2))),
        "K5 perm_f64_1MiB": (32 * m5, *scatter(
            32, m5, 2 * m5, lambda i: np.random.default_rng(i).permutation(
                2 * m5)[:m5])),
    }
    fsum = {name for name in rows if "_fsum_" in name}

    def flat(x):
        return [x] if isinstance(x, torch.Tensor) else \
            [t for y in x for t in flat(y)]

    ms_, digests = {}, {}
    if only:
        rows = {k: v for k, v in rows.items() if k.split()[0] in only}
    for name, (nbytes, make, fn, *nsets) in rows.items():
        nsets = nsets[0] if nsets else max(1, -(-COLD // div // nbytes))
        sets = [make(i) for i in range(nsets)]
        if name in fsum:  # float64 values: compared within 1e-9
            digests[name] = fn(sets[0]).view(torch.float64).tolist()
        else:
            h = hashlib.sha256()
            for t in flat(fn(sets[0])):
                h.update(t.cpu().contiguous().view(torch.uint8).numpy()
                         .tobytes())
            digests[name] = h.hexdigest()
        if cpu:
            continue
        for i in range(3):
            fn(sets[i % len(sets)])
        torch.cuda.synchronize()
        keep = []
        g = torch.cuda.CUDAGraph()
        n = max(iters if nsets > 1 else 4 * iters, len(sets))
        with torch.cuda.graph(g):
            for i in range(n):
                keep.append(fn(sets[i % len(sets)]))
        g.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        ms_[name] = a.elapsed_time(b) / n
        del g, keep, sets
    return {"root": root, "grouped": grouped, "ms": ms_, "digests": digests}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on the CPU at 1/64 of the sizes")
    ap.add_argument("--kernels", default="",
                    help="time only these kernels' rows, e.g. K4,K5")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(_child(a.roots[0], a.iters, a.cpu,
                                tuple(filter(None, a.kernels.split(","))))),
              flush=True)
        return 0
    if not a.cpu:
        import torch
        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA card available", file=sys.stderr)
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
             "--iters", str(a.iters), "--kernels", a.kernels, root]
            + (["--cpu"] if a.cpu else []),
            capture_output=True, text=True, timeout=1800)
        if p.returncode:
            sys.stderr.write(p.stdout[-4000:] + p.stderr[-8000:])
            raise RuntimeError(f"child for {root} exited {p.returncode}")
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    ok = True
    names = list(runs[0]["digests"])
    def same(a, b):
        if isinstance(a, str):
            return a == b
        return all(x == y or abs(x - y) <= 1e-9 * max(abs(x), abs(y))
                   for x, y in zip(a, b))

    for name in names:
        if not all(same(runs[0]["digests"][name], r["digests"][name])
                   for r in runs[1:]):
            print(f"[kernel_ab] {name}: the roots' results differ",
                  file=sys.stderr)
            ok = False
    order = list(dict.fromkeys(a.roots))
    for name in names if not a.cpu else []:
        med = {root: statistics.median(
            [r["ms"][name] for r in runs if r["root"] == root])
            for root in order}
        print(f"[kernel_ab] {name}: median ms "
              + ", ".join(f"{root} {med[root]:.4f}" for root in order),
              flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
