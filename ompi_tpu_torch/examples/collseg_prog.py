"""coll/seg exerciser under mpirun: every segment collective, both
the native C path and the Python protocol fallback, must agree with
reference results (ref: the coll/sm test pattern — same-node process
ranks meeting in a shared segment).  The port's copy of the
reference's ``tests/_collseg_prog.py``; its checks are the reference's.

    python -m ompi_tpu_torch.tools.mpirun -np 4 \
        ompi_tpu_torch/examples/collseg_prog.py [--python-path]

After the checks every rank prints ``SEGDIGEST rank={r} {sha256}``
of its results on integer vectors drawn from ``SEED`` (see the end of
the program), then ``SEGPVAR rank={r} native={n} python={p}``, the
``coll_seg_native_ops`` and ``coll_seg_python_ops`` pvars.

``--bench MIB REPS [--ab]`` skips the checks and times REPS host
``Allreduce`` SUM of MIB MiB of float64 (after one warm-up) from a
barrier; with ``--ab`` also the p2p route that ``--mca coll ^seg``
selects (coll/tuned, called directly), in turns: the comm's, tuned,
tuned, the comm's.  Rank 0 prints one JSON line: the provider of
``allreduce``, the slowest rank's microseconds an op of each run and
the results' check.
"""
import json
import sys
import time

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.coll.buffers import IN_PLACE
from ompi_tpu_torch.datatype import engine as dt
from ompi_tpu_torch.op import op as mpi_op

SEED = 20261018

comm = ompi_tpu_torch.init()
P, me = comm.size, comm.rank

if "--bench" in sys.argv:
    from ompi_tpu_torch.coll.tuned import TunedModule
    from ompi_tpu_torch.datatype import engine as dt
    i = sys.argv.index("--bench")
    n = (int(sys.argv[i + 1]) << 20) // 8
    reps = int(sys.argv[i + 2])
    xb = np.arange(n, dtype=np.float64) % 1024 + me
    want = (np.arange(n) % 1024) * P + sum(range(P))
    tuned = TunedModule()
    # the comm's allreduce (seg unless excluded), and the p2p route that
    # ``--mca coll ^seg`` selects (coll/tuned), in turns: A B B A
    routes = {"comm": lambda r: comm.Allreduce(xb, r, mpi_op.SUM),
              "tuned": lambda r: tuned.allreduce(comm, xb, r, n, dt.DOUBLE,
                                                 mpi_op.SUM)}
    order = ("comm", "tuned", "tuned", "comm") if "--ab" in sys.argv \
        else ("comm",)
    us = {k: [] for k in routes}
    exact = True
    for k in order:
        rb = np.empty_like(xb)
        routes[k](rb)  # warm-up: segment, buffers
        comm.Barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            routes[k](rb)
        dt_s = np.array([time.perf_counter() - t0])
        exact = exact and bool((rb == want).all())
        worst = np.empty(1)
        comm.Allreduce(dt_s, worst, mpi_op.MAX)
        us[k].append(float(worst[0]) / reps * 1e6)
    ok = np.array([int(exact)], np.int64)
    comm.Allreduce(ok.copy(), ok, mpi_op.MIN)
    if me == 0:
        print(json.dumps({
            "provider": comm.coll.providers.get("allreduce"),
            "ranks": P, "mib": sys.argv[i + 1], "reps": reps,
            "us": us["comm"][0], "us_comm": us["comm"],
            "us_tuned": us["tuned"], "exact": bool(ok[0])}), flush=True)
    ompi_tpu_torch.finalize()
    sys.exit(0)

# the segment must actually be selected for these comms
assert comm.coll.providers.get("allreduce") == "seg", \
    comm.coll.providers

force_python = "--python-path" in sys.argv
if force_python:
    # disable the native fast path: the Python protocol must produce
    # identical results (and interoperate with the same segment)
    import ompi_tpu_torch.coll.seg as segmod
    segmod.SegCollModule._native_run = \
        lambda self, *a, **k: False

# allreduce SUM f32
x = np.full(8, me + 1.0, np.float32)
r = np.empty_like(x)
comm.Allreduce(x, r, mpi_op.SUM)
assert (r == sum(range(1, P + 1))).all(), r

# allreduce MAX i64
xi = np.arange(4, dtype=np.int64) + me
ri = np.empty_like(xi)
comm.Allreduce(xi, ri, mpi_op.MAX)
assert (ri == np.arange(4) + P - 1).all(), ri

# allreduce BAND u32 (int-only op)
xb = np.full(4, 0xFF ^ (1 << me), np.uint32)
rb = np.empty_like(xb)
comm.Allreduce(xb, rb, mpi_op.BAND)
expect = 0xFF
for p in range(P):
    expect &= 0xFF ^ (1 << p)
assert (rb == expect).all(), rb

# IN_PLACE allreduce
buf = np.full(4, float(me), np.float64)
comm.Allreduce(IN_PLACE, buf, mpi_op.SUM)
assert (buf == sum(range(P))).all(), buf

# bcast
broot = min(2, P - 1)
b = np.arange(16.0, dtype=np.float64) if me == broot else np.zeros(16)
comm.Bcast(b, root=broot)
assert (b == np.arange(16.0)).all(), b

# reduce to a non-zero root
rr = np.empty(8, np.float32) if me == 1 else np.empty(8, np.float32)
rroot = 1 % P
comm.Reduce(x, rr, mpi_op.SUM, root=rroot)
if me == rroot:
    assert (rr == sum(range(1, P + 1))).all(), rr

# allgather
g = np.empty(P * 2, np.float32)
comm.Allgather(np.full(2, float(me), np.float32), g)
assert (g.reshape(P, 2) == np.arange(P)[:, None]).all(), g

# alltoall
sa = np.arange(P * 2, dtype=np.float32) + 100 * me
ra = np.empty_like(sa)
comm.Alltoall(sa, ra)
for p in range(P):
    assert (ra[p * 2:(p + 1) * 2] ==
            np.arange(me * 2, me * 2 + 2) + 100 * p).all(), ra

# reduce_scatter_block
srs = np.arange(P * 3, dtype=np.float64) + me
rrs = np.empty(3, np.float64)
comm.Reduce_scatter_block(srs, rrs, mpi_op.SUM)
base = np.arange(me * 3, me * 3 + 3) * P + sum(range(P))
assert (rrs == base).all(), (rrs, base)

# barrier ordering smoke: many barriers back-to-back (generation +
# bank reuse churn)
for _ in range(50):
    comm.Barrier()

# a payload bigger than the slot on a collective WITHOUT a chunked
# path (alltoall) must fall back to the p2p stack and still be right
from ompi_tpu_torch.mca.params import registry as _reg0
slot_b = _reg0.get("coll_seg_slot_bytes") or (8 << 20)
n_over = ((slot_b // 4) + P) // P * P  # per-rank rows exceed the slot
sa2 = (np.arange(n_over, dtype=np.float32) + 1000.0 * me)
ra2 = np.empty_like(sa2)
comm.Alltoall(sa2, ra2)
blk = n_over // P
for p in range(P):
    expect = np.arange(me * blk, (me + 1) * blk,
                       dtype=np.float32) + 1000.0 * p
    assert (ra2[p * blk:(p + 1) * blk] == expect).all(), p
# oversize allreduce takes the chunked segment path (checked below)

comm.Barrier()
if me == 0:
    print("collseg ok", flush=True)

# chunked large payloads: allreduce + bcast > slot stream through the
# segment in pieces
from ompi_tpu_torch.mca.params import registry as _reg
big_n = (_reg.get("coll_seg_slot_bytes") or (8 << 20)) // 4 * 3
bigx = np.arange(big_n, dtype=np.float32) * 0 + (me + 1)
bigr = np.empty_like(bigx)
comm.Allreduce(bigx, bigr, mpi_op.SUM)
assert (bigr == sum(range(1, P + 1))).all()
bb = np.arange(big_n, dtype=np.float32) if me == 0 \
    else np.full(big_n, -1.0, np.float32)
comm.Bcast(bb, root=0)
assert (bb == np.arange(big_n, dtype=np.float32)).all()

comm.Barrier()
if me == 0:
    print("collseg chunked ok", flush=True)
# seeded integer vectors (exact under any fold): every rank prints the
# digest of its Allreduce SUM / MAX / BXOR, Bcast and Allgather results
# (int64, 1 MiB a rank: the split reduce_scatter+allgather form)
import hashlib  # noqa: E402
h = hashlib.sha256()
for k, op in enumerate((mpi_op.SUM, mpi_op.MAX, mpi_op.BXOR)):
    xs = np.random.default_rng(SEED + 31 * k + me).integers(
        0, 1 << 40, 1 << 17)
    rs = np.empty_like(xs)
    comm.Allreduce(xs, rs, op)
    h.update(rs.tobytes())
bs = np.random.default_rng(SEED + 7).integers(0, 1 << 40, 4099) \
    if me == 0 else np.zeros(4099, np.int64)
comm.Bcast(bs, root=0)
h.update(bs.tobytes())
gs = np.empty(P * 33, np.int64)
comm.Allgather(np.random.default_rng(SEED + 11 + me).integers(
    0, 1 << 40, 33), gs)
h.update(gs.tobytes())
print(f"SEGDIGEST rank={me} {h.hexdigest()}", flush=True)
nat = _reg._pvars["coll_seg_native_ops"].read()
py = _reg._pvars["coll_seg_python_ops"].read()
print(f"SEGPVAR rank={me} native={nat} python={py}", flush=True)
ompi_tpu_torch.finalize()
