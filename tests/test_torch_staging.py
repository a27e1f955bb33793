"""The port's host staging (ompi_tpu_torch/runtime/staging.py), the plan
tier's pack and the device window's numpy buffers against the
reference's runtime/staging.py, plan and device window, from the same
numpy seeds, byte for byte.

The reference runs its device window under jax on the CPU, one rank a
virtual device (``run_ranks(devices=True)``); the port runs one rank a
logical device of the CPU (``testing.logical_devices("cpu")``).

Known divergences, pinned by the tests named after them:
  * the zero-copy answer is one a device type, not one a process: one
    process of the port holds CPU and card ranks alike, and a card
    answers False where the CPU answers True;
  * the port's pack and device window do not stage through the module:
    the pack is one ``torch.cat`` on every device, and the window
    copies a numpy buffer to or from its shard directly, with no pool;
  * the port keeps no write-through host mirror of a shard and no
    borrowed origin (a CPU shard already is host memory; on a card the
    shard is the only copy): the bytes of every put and get are the
    reference's all the same;
  * a card's staging buffer is pinned host memory, and where pinning
    fails ``aligned_empty`` raises instead of handing back pageable
    memory;
  * nothing about a context without a communicator: it takes
    ``init()``'s world in both packages (a singleton process here,
    ``test_shmem_init_without_a_comm_takes_the_world`` and
    ``test_shmem_ctx_default_comm_is_the_world``).
"""

import types

import jax
import numpy as np
import pytest
import torch

from ompi_tpu.coll import pipeline as ref_pipeline
from ompi_tpu.coll import plan as ref_plan
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu import osc as ref_osc
from ompi_tpu.osc import device as _ref_device  # noqa: F401
from ompi_tpu.runtime import staging as ref_staging
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import osc as port_osc
from ompi_tpu_torch import shmem as port_shmem
from ompi_tpu_torch.coll import pipeline as port_pipeline
from ompi_tpu_torch.coll import plan as port_plan
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.osc import device as port_device
from ompi_tpu_torch.runtime import staging
from ompi_tpu_torch.runtime.state import LogicalDevice
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")
SEED = 1234


def with_knob(name, value, run):
    """run() with the MCA variable ``name`` set in both registries,
    restored after (set around run_ranks, never inside a rank)."""
    saved = (port_registry.get(name), ref_registry.get(name))
    port_registry.set(name, value)
    ref_registry.set(name, value)
    try:
        return run()
    finally:
        port_registry.set(name, saved[0])
        ref_registry.set(name, saved[1])


# ---- the shared utility (tests/test_coll_plan.py test_staging_shared_
# ---- utility, through both packages) -----------------------------------

@pytest.mark.parametrize("nbytes", [1, 2, 63, 64, 1024, 4097])
def test_aligned_empty_alignment(nbytes):
    buf = staging.aligned_empty(nbytes)
    ref = ref_staging.aligned_empty(nbytes)
    assert staging.STAGE_ALIGN == ref_staging.STAGE_ALIGN == 64
    assert isinstance(buf, np.ndarray) and buf.dtype == np.uint8
    assert buf.ctypes.data % staging.STAGE_ALIGN == 0
    assert buf.nbytes == ref.nbytes == nbytes
    assert staging.aligned_empty(nbytes, LogicalDevice(CPU, 3)).nbytes \
        == nbytes


def test_probe_cached_and_agrees_with_reference():
    v1 = staging.runtime_zero_copy(CPU)
    assert isinstance(v1, bool)
    assert staging.runtime_zero_copy(CPU) is v1  # cached
    assert v1 is ref_staging.runtime_zero_copy() is True


def test_mirror_pool_take_park_reuse_and_bound():
    for pool, mk in ((staging.MirrorPool(max_buffers=2),
                      staging.aligned_empty),
                     (ref_staging.MirrorPool(max_buffers=2),
                      ref_staging.aligned_empty)):
        a = pool.take(256)
        assert a.ctypes.data % staging.STAGE_ALIGN == 0
        pool.park(a)
        b = pool.take(256)
        assert b.ctypes.data == a.ctypes.data  # reused, no fresh pages
        pool.park(b)
        pool.park(mk(256))
        pool.park(mk(256))  # beyond the bound: dropped
        assert len(pool._free) == 2
        pool.park(None)  # tolerated no-op
        assert len(pool._free) == 2
        small = pool.take(4096)  # nothing parked is big enough
        assert small.nbytes == 4096


def test_mirror_pool_counts_fresh_buffers_and_keeps_sizes_whole():
    """``allocs`` counts the fresh buffers take made; a slice parked
    comes back at its buffer's whole capacity, and past the bound the
    smallest buffer drops, so a warm pool fed a mixed ladder of sizes
    allocates nothing more."""
    pool = staging.MirrorPool(max_buffers=2)
    ladder = (8, 65536, 8, 1 << 20, 4096)
    counts = []
    for _ in range(3):
        for n in ladder:  # one in use at a time, of every size
            b = pool.take(n)
            assert b.nbytes == n
            pool.park(b)
        counts.append(pool.allocs)
    assert counts == [3, 3, 3]
    assert sorted(b.nbytes for b in pool._free)[-1] >= 1 << 20
    assert sorted(b.nbytes for b in pool._free)[0] >= 65536


def test_divergence_window_holds_no_pool():
    """The reference's device window rides the shared names (its shard
    table holds a MirrorPool); the port's copies numpy buffers to and
    from its shard directly and imports nothing of the module."""
    assert _ref_device._staging is ref_staging

    def fn(comm):
        win = port_osc.allocate(comm, 64)
        fields = set(type(win._tab).__slots__)
        win.free()
        return fields

    got = port_run_ranks(2, fn, device_map=logical_devices("cpu"))
    assert got == [{"arrs", "lock", "streams"}] * 2
    assert not hasattr(port_device, "_staging")


# ---- the plan tier's pack --------------------------------------------------

# float64 is left out: the reference (x64 off) packs it as float32
PACK_DTYPES = [np.float32, np.int32, np.int8, np.uint8, np.uint16]


@pytest.mark.parametrize("opname", ["MPI_SUM", "MPI_MAX", "MPI_PROD"])
@pytest.mark.parametrize("dt", PACK_DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("n", [1, 3, 1000, 4097])
def test_pack_cpu_branch_matches_reference(n, dt, opname):
    """``_pack`` on the CPU, where the reference takes its zero-copy
    branch: the port's one ``torch.cat`` compose gives the reference's
    bytes on ragged sizes, in a fresh 64-byte-aligned tensor, never the
    caller's buffer."""
    dt = np.dtype(dt)
    nsegs, seg = (1, 4 << 10) if n <= 4 << 10 else (2, 4 << 10)
    x = np.random.default_rng(SEED + n).integers(
        -100, 100, n).astype(dt)
    comm = types.SimpleNamespace(state=types.SimpleNamespace(tracer=None))
    rplan = ref_plan.Plan("hbm", nsegs, seg, dt,
                          ref_pipeline._pad_value(opname, dt), None, None,
                          jax.devices("cpu")[0])
    want = np.asarray(ref_plan._pack(comm, x, n, rplan))
    flat = torch.from_numpy(x.copy())
    tdt = flat.dtype
    pplan = port_plan.Plan("hbm", nsegs, seg, dt.itemsize,
                           port_pipeline._pad_value(opname, tdt), None)
    got = port_plan._pack(comm, flat, n, pplan)
    assert got.dtype == tdt and got.numel() == nsegs * seg
    assert got.numpy().tobytes() == want.tobytes()
    assert got.data_ptr() % staging.STAGE_ALIGN == 0
    assert got.data_ptr() != flat.data_ptr()
    assert flat.numpy().tobytes() == x.tobytes()


# ---- the device window's numpy buffers -----------------------------------

LADDER = (8, 1 << 10, 64 << 10)


def window_ladder(osc):
    """Numpy-origin puts and gets on a window of either package: every
    rank puts seeded blocks at every size into its right neighbour's
    window, then a get of its left neighbour's and a fetch_and_op and
    a compare_and_swap with numpy results; the raw bytes of it all."""
    def fn(comm):
        me, n = comm.rank, comm.size
        right, left = (me + 1) % n, (me - 1) % n
        total = sum(LADDER) + 16
        win = osc.allocate(comm, total, disp_unit=1)
        out = {}
        win.fence()
        off = 0
        for nb in LADDER:
            data = np.random.default_rng(SEED + me + nb).integers(
                0, 256, nb, dtype=np.uint8)
            win.put(data, right, disp=off)
            off += nb
        win.fence()
        off = 0
        for nb in LADDER:
            got = np.empty(nb, dtype=np.uint8)
            win.get(got, left, disp=off)
            out[f"get_{nb}"] = got.tobytes()
            off += nb
        win.fence()
        old = np.empty(1, dtype=np.int64)
        win.lock(0, osc.LOCK_SHARED)
        win.fetch_and_op(me + 1, old, 0, disp=off)
        win.unlock(0)
        comm.Barrier()
        cas = np.empty(1, dtype=np.int32)
        win.lock(0, osc.LOCK_SHARED)
        win.compare_and_swap(np.int32(0), np.int32(7), cas, 0, disp=off + 8)
        win.unlock(0)
        comm.Barrier()
        got = np.empty(16, dtype=np.uint8)
        win.lock(0, osc.LOCK_SHARED)
        win.get(got, 0, disp=off)
        win.unlock(0)
        out["atomics_cell"] = got.tobytes()
        comm.Barrier()
        win.free()
        return out
    return fn


@pytest.mark.parametrize("dma", ["1", "0"])
def test_divergence_no_write_through_mirror(dma):
    """No host mirror and no borrowed origin (the port's table holds
    shards, a lock and streams: ``test_divergence_window_holds_no_pool``),
    and yet every put and get gives the reference's bytes, through both
    lowerings."""
    ref = with_knob("osc_device_dma", dma, lambda: ref_run_ranks(
        4, window_ladder(ref_osc), devices=True))
    got = with_knob("osc_device_dma", dma, lambda: port_run_ranks(
        4, window_ladder(port_osc), device_map=logical_devices("cpu")))
    assert got == ref


@pytest.mark.parametrize("dma", ["1", "0"])
def test_put_frees_the_origin_at_once(dma):
    """The race case: put A at 0, put B at once at S, overwrite both in
    place before the fence; both regions hold the original bytes,
    through both lowerings."""
    S = 4096

    def fn(comm):
        win = port_osc.allocate(comm, 2 * S)
        win.fence()
        right = (comm.rank + 1) % comm.size
        a = np.full(S, 1 + comm.rank, dtype=np.uint8)
        b = np.full(S, 101 + comm.rank, dtype=np.uint8)
        win.put(a, right, disp=0)
        win.put(b, right, disp=S)
        a[:] = 0
        b[:] = 0
        win.fence()
        mem = win.memory.numpy().tobytes()
        win.free()
        return mem

    got = with_knob("osc_device_dma", dma, lambda: port_run_ranks(
        4, fn, device_map=logical_devices("cpu")))
    for r, mem in enumerate(got):
        left = (r - 1) % 4
        assert mem == bytes([1 + left]) * S + bytes([101 + left]) * S


# ---- divergences ----------------------------------------------------------

def test_divergence_probe_is_per_device_type():
    """One answer a device type, where the reference probes once a
    process: logical devices of the CPU alias, a card copies (no card
    needed to say so; ``test_pinned_staging_on_card`` holds it on one)."""
    assert staging.runtime_zero_copy(LogicalDevice(CPU, 5)) is True
    assert staging.runtime_zero_copy("cpu") is True
    assert staging.runtime_zero_copy(torch.device("cuda", 1)) is False
    assert staging.runtime_zero_copy(
        LogicalDevice(torch.device("cuda", 0), 3)) is False


def test_divergence_card_stage_is_pinned_or_raises():
    """A card's staging buffer is pinned host memory; where nothing
    can be pinned (no card here) it raises instead of returning
    pageable memory — in ``aligned_empty`` and through the pool."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: test_pinned_staging_on_card")
    with pytest.raises(RuntimeError):
        staging.aligned_empty(64, "cuda")
    with pytest.raises(RuntimeError):
        staging.MirrorPool(device=torch.device("cuda", 0)).take(64)


# A singleton process of either package (``init()`` with no launcher)
# runs a shmem program on the world ``init()`` gives it; each prints
# one JSON line.  In a child process: ``init()`` publishes its world
# process-wide, which a test process must not keep.
_SINGLETON_PE = """
import importlib, json, sys
import numpy as np
pkg = importlib.import_module(sys.argv[1])
shmem = importlib.import_module(sys.argv[1] + ".shmem")
comm = pkg.init()
if sys.argv[2] == "init":
    shmem.init()
    x = shmem.malloc(8, np.int64)
    shmem.put(x, np.arange(8, dtype=np.int64) * 3, pe=0)
    shmem.quiet()
    got = shmem.get(x, pe=0)
    old = shmem.atomic_fetch_add(x, 2, 5, pe=0)
    shmem.barrier_all()
    out = {"n_pes": shmem.n_pes(), "my_pe": shmem.my_pe(),
           "get": np.asarray(got).tolist(), "old": int(old),
           "after": np.asarray(shmem.get(x, pe=0)).tolist()}
    shmem.finalize()
else:
    a = shmem.ShmemCtx()
    b = shmem.ShmemCtx(comm=pkg.init())
    out = {"same_comm": a.comm is b.comm is comm,
           "pes": [a.comm.size, b.comm.size],
           "heap": [a.heap_size, b.heap_size],
           "cid": [a.comm.cid, b.comm.cid, comm.cid]}
    a.finalize()
    b.finalize()
pkg.finalize()
print(json.dumps(out))
"""


def _singleton_pe(mode: str):
    """(reference, port) JSON results of ``_SINGLETON_PE`` in ``mode``,
    the two children run at once."""
    import json
    import os
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=repo + os.pathsep + os.environ.get(
                   "PYTHONPATH", ""))
    for k in [k for k in env if k.startswith("TPUMPI_")]:
        del env[k]  # a singleton: no launcher in sight
    procs = [subprocess.Popen([sys.executable, "-c", _SINGLETON_PE, pkg,
                               mode], env=env, cwd=repo,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for pkg in ("ompi_tpu", "ompi_tpu_torch")]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    return outs


def test_shmem_init_without_a_comm_takes_the_world():
    """``shmem.init()`` with no communicator takes ``init()``'s world, as
    the reference's does: one PE, a put/get and an atomic fetch-add on
    PE 0 give the reference's values."""
    ref, port = _singleton_pe("init")
    assert port == ref
    assert port["n_pes"] == 1 and port["my_pe"] == 0
    assert port["get"] == [3 * i for i in range(8)]
    assert port["old"] == 6 and port["after"][2] == 11


def test_shmem_ctx_default_comm_is_the_world():
    """``ShmemCtx()`` and ``ShmemCtx(comm=init())`` stand on the same
    communicator (``init()``'s COMM_WORLD): the same PE count, heap
    size and cid, in both packages."""
    ref, port = _singleton_pe("ctx")
    assert port == ref
    assert port["same_comm"] and port["pes"] == [1, 1]
    assert port["heap"][0] == port["heap"][1]
    assert len(set(port["cid"])) == 1


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs, never
    when the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned staging needs one)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_pinned_staging_on_card(cuda_device):
    """On the card the zero-copy answer is False, every stage of the
    pool is pinned, and bytes staged through it (a queued copy each
    way) equal the window's numpy put and get, which copy from and to
    pageable memory, both lowerings."""
    assert staging.runtime_zero_copy(cuda_device) is False
    nb = 1 << 20
    pool = staging.MirrorPool(max_buffers=4, device=cuda_device)

    def staged_round_trip(data):
        up = pool.take(nb)
        up.numpy()[:] = data
        card = torch.empty(nb, dtype=torch.uint8, device=cuda_device)
        card.copy_(up, non_blocking=True)
        down = pool.take(nb)
        down.copy_(card, non_blocking=True)
        torch.cuda.synchronize(cuda_device)
        pinned = up.is_pinned() and down.is_pinned()
        pool.park(up)
        pool.park(down)
        return card.cpu().numpy().tobytes(), down.numpy().tobytes(), pinned

    def fn(comm):
        win = port_osc.allocate(comm, nb)
        right = (comm.rank + 1) % comm.size
        data = np.random.default_rng(SEED + comm.rank).integers(
            0, 256, nb, dtype=np.uint8)
        win.fence()
        win.put(data, right)
        win.fence()
        mem = win.memory.cpu().numpy().tobytes()
        back = np.empty(nb, dtype=np.uint8)
        win.get(back, right)
        win.fence()
        win.free()
        return mem, back.tobytes()

    want = [np.random.default_rng(SEED + r).integers(0, 256, nb,
                                                     dtype=np.uint8)
            for r in range(4)]
    staged = [staged_round_trip(x) for x in want]
    assert all(p for _, _, p in staged)
    assert pool.allocs == 2
    for dma in ("1", "0"):
        got = with_knob("osc_device_dma", dma, lambda: port_run_ranks(
            4, fn, device_map=logical_devices(cuda_device)))
        for r, (mem, back) in enumerate(got):
            assert mem == staged[(r - 1) % 4][0], (dma, r)
            assert back == staged[r][1], (dma, r)
