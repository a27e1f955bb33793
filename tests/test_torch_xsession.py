"""Cross-session fused batches through both packages: two resident
sessions (two thread worlds of one process, at the same time) flush
their nonblocking device batches inside the cross-session window and
ride ONE combined dispatch — coll/hbm (every rank on one device: one
K3 call a (op, dtype) group for both sessions' slots) and the mesh tier
(logical devices: one K6 and one K2 peer launch a card a group over
both sessions' group buffers).  The port's sessions are
``testing.sessions.run_sessions`` in cid bands 1 and 2; the
reference's are two ``run_ranks`` worlds started together, with its
``set_xsession_hint(2)`` and ``dvm_batch_window_us`` set as its pool
would set them.  The wrappers take their plain versions on the CPU.
Every knob and both hints are restored in a ``finally``.

Tolerance: byte for byte.  The batches hold int32 MAX/MIN slots and
float32 SUM slots of small integers (exact under any fold order), a
bcast slot, and a scalar; the dtype and shape of every result are
compared too.  The window (800 ms, as the reference's own test) is
long against the CPU's jitter, and every rank passes a Barrier before
its flush.
"""

import threading
import time

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.fusion as ref_fusion
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.coll import device, fusion
from ompi_tpu_torch.kernels import fused, mesh
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks
from ompi_tpu_torch.testing.sessions import run_sessions

CPU = torch.device("cpu")
N = 4
WINDOW_US = 800_000
MODES = ("hbm", "mesh")


def _port_map(mode):
    return (lambda r: CPU) if mode == "hbm" else logical_devices("cpu")


class xwindow:
    """The window knob in both registries and both packages' hints
    (None leaves a package's hint alone); restored on exit."""

    def __init__(self, window_us, hint=None) -> None:
        self.window_us = window_us
        self.hint = hint

    def __enter__(self):
        self.saved = [(reg, reg.get("dvm_batch_window_us"))
                      for reg in (ref_registry, port_registry)]
        self.hints = (ref_fusion._xsession_hint, fusion._xsession_hint)
        for reg, _ in self.saved:
            reg.set("dvm_batch_window_us", self.window_us)
        if self.hint is not None:
            ref_fusion.set_xsession_hint(self.hint)
            fusion.set_xsession_hint(self.hint)
        return self

    def __exit__(self, *exc):
        for reg, v in self.saved:
            reg.set("dvm_batch_window_us", v)
        ref_fusion.set_xsession_hint(self.hints[0])
        fusion.set_xsession_hint(self.hints[1])


def _inputs(session, rank):
    """Session- and rank-seeded payloads of one batch: (kind, array,
    op name or root)."""
    rng = np.random.default_rng(1000 * session + rank)
    return [
        ("allreduce", rng.integers(-40, 40, 300).astype(np.float32),
         "SUM"),
        ("allreduce", rng.integers(-1 << 30, 1 << 30, 77).astype(np.int32),
         "MAX"),
        ("allreduce", rng.integers(-1 << 30, 1 << 30, 33).astype(np.int32),
         "MIN"),
        ("bcast", rng.integers(-9, 9, 12).astype(np.int32), 1),
        ("allreduce", np.asarray(rng.integers(-5, 5), dtype=np.float32),
         "SUM"),
        ("allreduce", rng.integers(-40, 40, 1025).astype(np.float32),
         "SUM"),
    ]


def _program(put, ops, session_of):
    """fn(comm) for run_ranks: one batch, flushed after a Barrier;
    returns every result as (dtype, shape, bytes)."""
    def fn(comm):
        s = session_of(comm)
        ins = _inputs(s, comm.rank)
        comm.Barrier()
        reqs = []
        for kind, x, extra in ins:
            if kind == "bcast":
                reqs.append(comm.ibcast_arr(put(comm, x), extra))
            else:
                reqs.append(comm.iallreduce_arr(put(comm, x),
                                                getattr(ops, extra)))
        comm.flush_arr()
        out = []
        for q in reqs:
            q.wait()
            r = q.result
            a = convert.to_numpy(r) if isinstance(r, torch.Tensor) \
                else np.asarray(r)
            out.append((str(a.dtype), a.shape, a.tobytes()))
        return out
    return fn


def _port_put(comm, x):
    return convert.to_torch(x, comm.state.device)


def _ref_put(comm, x):
    return jax.device_put(x, comm.device)


def _port_sessions(mode, window_us=WINDOW_US):
    fn = _program(_port_put, port_op, lambda c: c.state.cid_band - 1)
    return run_sessions(2, N, fn, device_map=_port_map(mode),
                        window_us=window_us)


def _ref_sessions(mode):
    res = [None, None]
    errs = []

    def world(s):
        fn = _program(_ref_put, ref_op, lambda c: s)
        try:
            if mode == "hbm":
                res[s] = ref_run_ranks(
                    N, fn, device_map=lambda r: jax.devices()[0])
            else:
                res[s] = ref_run_ranks(N, fn, devices=True)
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=world, args=(s,)) for s in (0, 1)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errs:
        raise errs[0]
    return res


@pytest.mark.parametrize("mode", MODES)
def test_two_sessions_match_reference(mode):
    """Both packages' two sessions combine (their dvm_xsession_batches
    rise) and the port's outputs equal the reference's, session by
    session and rank by rank, byte for byte."""
    rb0 = ref_fusion._pv_xbatches.read()
    pb0 = fusion._pv_xbatches.read()
    with xwindow(WINDOW_US, hint=2):
        ref = _ref_sessions(mode)
        port = _port_sessions(mode)
    assert ref_fusion._pv_xbatches.read() > rb0
    assert fusion._pv_xbatches.read() > pb0
    assert port == ref


@pytest.mark.parametrize("mode", MODES)
def test_combined_equals_solo(mode):
    """In the port, each session's combined outputs equal its solo run
    (window closed, one session at a time, same band) byte for byte;
    the combined dispatches carried both sessions' collectives, and
    each band's fused_batches counts its own flushes."""
    xb0, xc0 = fusion._pv_xbatches.read(), fusion._pv_xcolls.read()
    fb = [fusion._pv_batches.read_band(b) for b in (1, 2)]
    g0 = fusion._pv_batches.read()
    combined = _port_sessions(mode)
    xb = fusion._pv_xbatches.read() - xb0
    assert xb >= 1
    assert fusion._pv_xcolls.read() - xc0 == xb * 2 * len(_inputs(0, 0))
    # one flush a rank a session: N a band, 2N in all
    assert [fusion._pv_batches.read_band(b) - f0
            for b, f0 in zip((1, 2), fb)] == [N, N]
    assert fusion._pv_batches.read() - g0 == 2 * N
    fn = _program(_port_put, port_op, lambda c: c.state.cid_band - 1)
    with xwindow(0, hint=0):
        solo = [run_ranks(N, fn, device_map=_port_map(mode), cid_band=s + 1)
                for s in (0, 1)]
    assert combined == solo


def _entry_args(size, sig, seed):
    rng = np.random.default_rng(seed)
    return [[torch.from_numpy(rng.integers(-50, 50, shape).astype(
        np.float32 if dt == torch.float32 else np.int32))
        for _kind, shape, dt, _e in sig] for _ in range(size)]


@pytest.mark.parametrize("first", (0, 1))
def test_arrival_order_does_not_change_bytes(first):
    """Through the batcher itself: whichever session arrives first (and
    leads), the combined dispatch sees the signatures in one sorted
    order and hands each session the same bytes."""
    size = 3
    sigs = [(("allreduce", (40,), torch.float32, "MPI_SUM"),
             ("allreduce", (7,), torch.int32, "MPI_MAX")),
            (("allreduce", (9,), torch.float32, "MPI_SUM"),
             ("bcast", (5,), torch.int32, 2))]
    args = [_entry_args(size, sig, 7 + s) for s, sig in enumerate(sigs)]
    seen = []

    def multi(ss, aa):
        seen.append(tuple(ss))
        return fusion._hbm_batch_outs(size, ss, aa)

    outs = [None, None]

    def go(s):
        outs[s] = fusion._xdispatch(
            ("order", first), sigs[s], args[s],
            lambda a: fusion._hbm_slot_outs(size, sigs[s], a), multi,
            lambda ss: fusion._hbm_fits(size, ss))

    with xwindow(300_000, hint=2):
        t1 = threading.Thread(target=go, args=(first,))
        t1.start()
        time.sleep(0.05)
        go(1 - first)
        t1.join()
    assert seen == [tuple(sorted(sigs, key=repr))]
    for s in (0, 1):
        solo = fusion._hbm_slot_outs(size, sigs[s], args[s])
        for r in range(size):
            for got, want in zip(outs[s][r], solo[r]):
                assert got.dtype == want.dtype
                assert got.numpy().tobytes() == want.numpy().tobytes()


@pytest.mark.parametrize("window_us,hint", ((0, 2), (5_000_000, 1),
                                            (5_000_000, 0)))
def test_closed_window_runs_straight_through(window_us, hint):
    """Window 0, or fewer than 2 resident sessions: ``_xdispatch`` runs
    the solo dispatch at once, on the caller's thread, and counts no
    combined dispatch."""
    xb0 = fusion._pv_xbatches.read()
    calls = []
    with xwindow(window_us, hint=hint):
        t0 = time.monotonic()
        out = fusion._xdispatch(("straight",), (), [],
                                lambda a: calls.append(a) or "solo",
                                lambda ss, aa: "combined",
                                lambda ss: True)
        took = time.monotonic() - t0
    assert out == "solo" and calls == [[]]
    assert took < 1.0
    assert fusion._pv_xbatches.read() == xb0


def test_mismatched_batch_raises_on_every_member():
    """A session whose ranks enqueue different batches raises the
    mismatch on every one of its members, with the window open; the
    other session's batch still completes, equal to its solo run."""
    good = _program(_port_put, port_op, lambda c: c.state.cid_band - 1)

    def fn(comm):
        if comm.state.cid_band == 2:
            return good(comm)
        x = np.ones(5 + (comm.rank == 1), np.float32)
        comm.Barrier()
        req = comm.iallreduce_arr(_port_put(comm, x), port_op.SUM)
        try:
            comm.flush_arr()
        except RuntimeError as e:
            with pytest.raises(RuntimeError):
                req.wait()
            return str(e)
        return "no error"

    res = run_sessions(2, N, fn, device_map=lambda r: CPU,
                       window_us=WINDOW_US)
    assert all("fused-collective batch mismatch" in m for m in res[0])
    with xwindow(0, hint=0):
        solo = run_ranks(N, good, device_map=lambda r: CPU, cid_band=2)
    assert res[1] == solo


def test_sessions_past_one_launch_lead_windows_of_their_own():
    """Five sessions of 8 ranks, each flushing two batches of 32 SUM
    slots: one K3 launch holds 128 slots at 8 ranks, so at most four
    sessions ride one combined dispatch, and a fifth batch leads a
    window of its own.  Every session's outputs equal its solo run
    byte for byte, every combined dispatch stayed within one launch a
    group, and at least two combined dispatches ran."""
    k, n, slots = 5, 8, 32
    assert fused.per_launch(n) == 4 * slots

    def fn(comm):
        s = comm.state.cid_band - 1
        out = []
        for flush in range(2):
            rng = np.random.default_rng(100 * s + 10 * flush + comm.rank)
            comm.Barrier()
            reqs = [comm.iallreduce_arr(torch.from_numpy(
                rng.integers(-99, 99, 5 + i).astype(np.float32)),
                port_op.SUM) for i in range(slots)]
            comm.flush_arr()
            for q in reqs:
                q.wait()
                out.append(q.result.numpy().tobytes())
        return out

    carried = []
    real = fusion._hbm_batch_outs

    def spy(size, sigs, arrays):
        if len(sigs) > 1:
            carried.append([len(sig) for sig in sigs])
        return real(size, sigs, arrays)

    xb0 = fusion._pv_xbatches.read()
    fusion._hbm_batch_outs = spy
    try:
        combined = run_sessions(k, n, fn, device_map=lambda r: CPU,
                                window_us=WINDOW_US)
    finally:
        fusion._hbm_batch_outs = real
    assert fusion._pv_xbatches.read() - xb0 == len(carried) >= 2
    assert all(sum(c) <= fused.per_launch(n) for c in carried)
    with xwindow(0, hint=0):
        solo = [run_ranks(n, fn, device_map=lambda r: CPU, cid_band=s + 1)
                for s in range(k)]
    assert combined == solo


def test_a_batch_that_does_not_fit_leads_its_own_window():
    """Through the batcher itself, with a fit that admits two batches:
    of three arrivals inside one window, the first two combine and the
    third, refused, leads a window of its own and runs solo; the
    window it found takes no more batches."""
    seen = []
    outs = {}

    def out(tag, how):
        return [[torch.tensor([ord(tag), how])]]

    def go(tag):
        outs[tag] = fusion._xdispatch(
            ("fit",), (tag,), [],
            lambda a: seen.append(("solo", tag)) or out(tag, 0),
            lambda ss, aa: seen.append(("combined", tuple(ss)))
            or [out(s[0], 1) for s in ss],
            lambda ss: len(ss) <= 2)

    with xwindow(300_000, hint=3):
        ts = []
        for tag in "abc":
            ts.append(threading.Thread(target=go, args=(tag,)))
            ts[-1].start()
            time.sleep(0.05)
        for t in ts:
            t.join()
    assert sorted(seen) == [("combined", (("a",), ("b",))), ("solo", "c")]
    assert {t: o[0][0].tolist() for t, o in outs.items()} == \
        {"a": [ord("a"), 1], "b": [ord("b"), 1], "c": [ord("c"), 0]}


@pytest.mark.parametrize("n", (8, 64))
def test_fits_agree_with_the_tables(n):
    """``_hbm_fits`` and ``_mesh_fits`` admit k sessions exactly where
    the combined dispatch is one launch a group: a K3 table of every
    session's slots (on the CPU the wrapper checks the bound as on a
    card), and K6's table over k sets when all N members share one
    device (the N stripes, cut by each boundary between sets)."""
    sig = (("allreduce", (3,), torch.int32, "MPI_SUM"),) * 4
    for k in range(1, fused.per_launch(n) // 4 + 2):
        fits = fusion._hbm_fits(n, [sig] * k)
        assert fits == (4 * k <= fused.per_launch(n))
        slots = [([torch.zeros(3, dtype=torch.int32)] * n, None)] * (4 * k)
        if fits:
            fused.fused_batch(slots, "MPI_SUM", split=False)
        else:
            with pytest.raises(ValueError, match="exceed one launch"):
                fused.fused_batch(slots, "MPI_SUM", split=False)
    per = mesh.sets_per_launch(n)
    assert per == {8: 16, 64: 1}[n]
    for k in (per, per + 1):
        assert fusion._mesh_fits(n, [sig] * k) == (k <= per)
        # every stripe non-empty, the boundaries between sets inside
        # stripes
        sets = [[torch.ones(16 * n - 2 + 4 * p, dtype=torch.int32)
                 for _ in range(n)] for p in range(k)]
        if k <= per:
            got = device._mesh_allreduce_sets(sets, "MPI_SUM", split=False)
            assert all(bool((t == n).all()) for per_set in got
                       for t in per_set)
        else:
            with pytest.raises(ValueError, match="mesh_fold"):
                device._mesh_allreduce_sets(sets, "MPI_SUM", split=False)


def test_plain_k3_over_a_combined_table():
    """K3's plain version over one table of both sessions' slots (a
    fold group with a bcast entry) equals the per-session plain calls;
    the wrapper on the CPU gives the same, and refuses a table past one
    launch with split=False."""
    rng = np.random.default_rng(5)
    n = 8

    def slots(k, root_every):
        out = []
        for i in range(k):
            xs = [torch.from_numpy(rng.integers(-99, 99, 17 + i).astype(
                np.int32)) for _ in range(n)]
            out.append((xs, (i % n) if i % root_every == 0 else None))
        return out

    a, b = slots(32, 5), slots(32, 7)
    both = fused.fused_batch_plain(a + b, "MPI_SUM")
    assert [[t.numpy().tobytes() for t in per] for per in both] == \
        [[t.numpy().tobytes() for t in per]
         for per in fused.fused_batch_plain(a, "MPI_SUM")
         + fused.fused_batch_plain(b, "MPI_SUM")]
    got = fused.fused_batch(a + b, "MPI_SUM", split=False)
    assert [[t.numpy().tobytes() for t in per] for per in got] == \
        [[t.numpy().tobytes() for t in per] for per in both]
    assert fused.per_launch(8) == 128
    with pytest.raises(ValueError, match="exceed one launch"):
        fused.fused_batch(slots(129, 3), "MPI_SUM", split=False)


def test_mesh_sets_equal_per_set_allreduce():
    """The combined mesh allreduce over two sessions' group buffers (of
    different lengths, one set a session) equals each set's own
    rank-order allreduce byte for byte, on CPU logical devices."""
    rng = np.random.default_rng(9)
    n = 8
    sets = [[torch.from_numpy(rng.integers(-1000, 1000, m).astype(
        np.float32)) for _ in range(n)] for m in (4099, 130, 1)]
    got = device._mesh_allreduce_sets(sets, "MPI_SUM")
    for xs, per in zip(sets, got):
        want = device._mesh_allreduce(xs, "MPI_SUM")
        assert [t.numpy().tobytes() for t in per] == \
            [t.numpy().tobytes() for t in want]


def test_fold_tables_read_each_jobs_set():
    """K6's planner over two input sets: a job of set k reads pointers
    k * N .. k * N + N - 1 (``in0``), and its head is planned against
    those pointers' alignment, not set 0's."""
    n, isz = 4, 4
    set0 = [0x10000 + 4096 * j for j in range(n)]       # aligned
    set1 = [0x80004 + 4096 * j for j in range(n)]       # 4 bytes past
    jobs = [("dev", 0x200000, 0, 1000, 0), ("dev", 0x300004, 0, 1000, 1),
            ("dev", 0x400000, 0, 1000, 1)]
    (dev, a), = mesh._fold_tables(set0 + set1, jobs, isz, nin=n)
    assert dev == "dev" and a.nin == n and a.njobs == 3
    assert [a.job[q].in0 for q in range(3)] == [0, n, n]
    assert a.job[0].head == 0
    assert a.job[1].head == 3     # congruent 4 bytes past a vector
    assert a.job[2].head == -1    # the output is not congruent: edge path
    assert [a.inp[i] for i in range(2 * n)] == set0 + set1
    with pytest.raises(ValueError):
        mesh._fold_tables(list(range(mesh.MAX_PTRS + n)), jobs, isz,
                          nin=n)
