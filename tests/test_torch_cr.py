"""Checkpoint/restart through the port (ompi_tpu_torch/cr: the
sequence-directory store, quiesce, checkpoint/restore and the shard
image), with the reference beside it.

The launcher-free cases of tests/test_cr.py and the shard cases of
tests/test_ckpt.py, plus tensor payloads: nested, bfloat16, bool and
int64, restored onto the caller's device (a ``torch.device``, a
``LogicalDevice`` — its real device — or the CPU), and a card tensor
mutated after its snapshot was planned.  The same numpy values go
through both packages (jax arrays in the reference, tensors in the
port); blob bytes differ (the residue pickles each package's classes),
so parity is on the values restored.  Tolerance: bytes.

Pinned divergences, each with the test named after it:
  * a tensor leaf is snapshotted when it is planned, where the
    reference holds its immutable jax leaves by reference
    (``test_divergence_tensor_leaves_snapshotted_at_plan``);
  * a tensor shard is tagged with the torch dtype's name and carries
    its bytes through ``view(torch.uint8)``, where the reference tags
    numpy dtype strings (``test_divergence_tensor_dtype_tags``).
"""

import os
import pickle

import numpy as np
import pytest
import torch

from ompi_tpu import cr as ref_cr
from ompi_tpu.cr import shard as ref_shard
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import cr
from ompi_tpu_torch.cr import shard
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.runtime.staging import STAGE_ALIGN
from ompi_tpu_torch.runtime.state import LogicalDevice
from ompi_tpu_torch.testing import logical_devices, run_ranks

SEED = 20261018
CPU = torch.device("cpu")


@pytest.fixture
def restart_env():
    os.environ[cr.ENV_RESTART] = "1"
    yield
    os.environ.pop(cr.ENV_RESTART, None)


def _values(x):
    """A leaf's values as numpy (jax, tensor — bfloat16 through
    float32, exact — or numpy)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


# ---- sstore analog: layout, atomicity ------------------------------

@pytest.mark.parametrize("mod", [cr, ref_cr], ids=["port", "ref"])
def test_store_latest_complete_and_pruning(tmp_path, mod):
    st = mod.Store(str(tmp_path))
    assert st.latest_complete() is None
    for seq in range(3):
        st.write_rank(seq, 0, {"payload": seq})
        st.mark_complete(seq, {"nprocs": 1, "seq": seq})
    st.write_rank(3, 0, {"payload": 3})  # incomplete newest: ignored
    assert st.latest_complete() == 2
    assert st.read_rank(2, 0)["payload"] == 2
    st.prune(keep=1)
    assert st.latest_complete() == 2
    assert not os.path.exists(st.seq_path(0))
    assert not os.path.exists(st.seq_path(1))
    assert os.path.exists(st.seq_path(3))  # never pruned: may be mid-write


def test_store_rank_write_is_atomic(tmp_path):
    st = cr.Store(str(tmp_path))
    st.write_rank(0, 0, {"payload": 1})
    assert all(not f.startswith(".") for f in os.listdir(st.seq_path(0)))


def test_store_compression_roundtrip_and_back_compat(tmp_path):
    """Images gzip by default (format marker) and shrink compressible
    payloads; raw images — written with compression off, or by hand —
    still read, and the reference reads the port's images."""
    store = cr.Store(str(tmp_path))
    blob = {"payload": np.zeros(64 * 1024, dtype=np.float64),
            "pml_msgs": []}
    store.write_rank(1, 0, blob)
    assert os.path.getsize(os.path.join(store.seq_path(1),
                                        "rank_0.ckpt")) < 64 * 1024 * 2
    np.testing.assert_array_equal(store.read_rank(1, 0)["payload"],
                                  blob["payload"])
    np.testing.assert_array_equal(
        ref_cr.Store(str(tmp_path)).read_rank(1, 0)["payload"],
        blob["payload"])
    registry.set("cr_base_compress", False)
    try:
        store.write_rank(2, 0, blob)
        assert os.path.getsize(os.path.join(
            store.seq_path(2), "rank_0.ckpt")) > 64 * 1024
        np.testing.assert_array_equal(store.read_rank(2, 0)["payload"],
                                      blob["payload"])
    finally:
        registry.set("cr_base_compress", True)
    with open(os.path.join(store.seq_path(1), "rank_9.ckpt"), "wb") as f:
        pickle.dump(blob, f)
    np.testing.assert_array_equal(store.read_rank(1, 9)["payload"],
                                  blob["payload"])


# ---- quiesce + snapshot-carried messages ---------------------------

def test_quiesce_carries_unreceived_eager(tmp_path, restart_env):
    d = str(tmp_path)

    def fn(comm, mod):
        if comm.rank == 0:
            comm.Send(np.array([42.0]), dest=1, tag=5)
        assert mod.checkpoint(comm, {"step": 7}, store_dir=d) == 0
        assert mod.restore(comm, store_dir=d) == {"step": 7}
        if comm.rank == 1:
            r = np.empty(1)
            comm.Recv(r, source=0, tag=5)
            assert r[0] == 42.0
        comm.Barrier()
        return True

    assert run_ranks(4, lambda c: fn(c, cr)) == [True] * 4
    d = str(tmp_path / "ref")
    assert ref_run_ranks(4, lambda c: fn(c, ref_cr)) == [True] * 4


def test_quiesce_carries_an_unreceived_device_payload(tmp_path,
                                                      restart_env):
    """A send_arr whose receive has not been posted is a parked object
    message at quiesce: the snapshot keeps a host copy, restore
    re-places it on the receiver's device, and recv_arr gets it."""
    d = str(tmp_path)

    def fn(comm):
        if comm.rank == 0:
            comm.send_arr(torch.arange(6, dtype=torch.int32), 1, tag=3)
        cr.checkpoint(comm, None, store_dir=d)
        cr.restore(comm, store_dir=d)
        if comm.rank == 1:
            got = [comm.recv_arr(0, tag=3) for _ in range(2)]
            assert all(g.device == comm.state.device for g in got)
            return [g.tolist() for g in got]
        return None

    r = run_ranks(2, fn, device_map=lambda r: CPU)
    assert r[1] == [list(range(6))] * 2  # the original and the restored


@pytest.mark.parametrize("dm", ["cpu", "logical"])
def test_tensor_payload_roundtrip(tmp_path, restart_env, dm):
    """Tensors anywhere in the payload come back on each rank's device
    with their values; the reference's jax payload from the same numpy
    values restores the same values."""
    d = str(tmp_path)
    device_map = (lambda r: CPU) if dm == "cpu" else \
        logical_devices("cpu")

    def fn(comm):
        x = torch.arange(8.0) * (comm.rank + 1)
        cr.checkpoint(comm, {"x": x, "nested": [x, (1, x)]}, store_dir=d)
        got = cr.restore(comm, store_dir=d)
        assert isinstance(got["x"], torch.Tensor)
        assert got["x"].device == comm.state.device
        return (_values(got["x"]).tobytes(),
                _values(got["nested"][1][1]).tobytes())

    def ref_fn(comm):
        import jax.numpy as jnp
        x = jnp.arange(8.0, dtype=jnp.float32) * (comm.rank + 1)
        ref_cr.checkpoint(comm, {"x": x, "nested": [x, (1, x)]},
                          store_dir=d + "_ref")
        got = ref_cr.restore(comm, store_dir=d + "_ref")
        return (np.asarray(got["x"]).tobytes(),
                np.asarray(got["nested"][1][1]).tobytes())

    assert run_ranks(2, fn, device_map=device_map) == \
        ref_run_ranks(2, ref_fn, devices=True)


def test_restore_topology_mismatch_raises(tmp_path, restart_env):
    d = str(tmp_path)
    assert run_ranks(2, lambda c: cr.checkpoint(c, {"a": 1},
                                                store_dir=d)) == [0, 0]
    st = cr.Store(d)
    seq = st.latest_complete()
    meta = st.read_meta(seq)
    meta["nprocs"] = 5
    st.mark_complete(seq, meta)

    def read(comm):
        with pytest.raises(RuntimeError, match="topology mismatch"):
            cr.restore(comm, store_dir=d)
        return True

    assert run_ranks(2, read) == [True, True]


def test_restore_without_restart_flag_is_a_fresh_start(tmp_path):
    assert run_ranks(2, lambda c: cr.restore(c, store_dir=str(tmp_path))) \
        == [None, None]


@pytest.mark.parametrize("dm", [None, "logical"], ids=["host", "device"])
def test_shmem_heap_snapshot(tmp_path, restart_env, dm):
    """checkpoint(shmem_ctx=) snapshots the PE's symmetric heap (the
    numpy heap, or the device heap's shard read back) and its
    allocator; restore puts both back after a clobber."""
    d = str(tmp_path)

    def fn(comm):
        from ompi_tpu_torch.shmem import ShmemCtx
        ctx = ShmemCtx(comm, heap_size=4096)
        assert ctx.device == (dm is not None)
        arr = ctx.malloc((8,), np.float64)
        ctx.put(arr, np.full(8, comm.rank + 0.5), comm.rank)
        ctx.barrier_all()
        cr.checkpoint(comm, None, store_dir=d, shmem_ctx=ctx)
        ctx.put(arr, np.full(8, -1.0), comm.rank)  # clobber
        ctx.barrier_all()
        extra = ctx.malloc((4,), np.float64)       # and allocate
        cr.restore(comm, store_dir=d, shmem_ctx=ctx)
        again = ctx.malloc((4,), np.float64)
        ok = (bool(np.all(np.asarray(arr.local) == comm.rank + 0.5))
              and again.offset == extra.offset)
        ctx.finalize()
        return ok

    device_map = logical_devices("cpu") if dm else None
    assert run_ranks(2, fn, device_map=device_map) == [True, True]


def test_local_tiers_wait_for_message_logging(tmp_path):
    """The uncoordinated tier needs sender-based message logging: with
    pml/vprotocol off, checkpoint_local raises naming the knob that
    turns it on (as the reference's does), and restore_local without
    the restart flag is a fresh start (None)."""
    def fn(comm):
        with pytest.raises(RuntimeError, match="pml_vprotocol pessimist"):
            cr.checkpoint_local(comm, {}, store_dir=str(tmp_path))
        return cr.restore_local(comm, store_dir=str(tmp_path))

    assert run_ranks(2, fn) == [None, None]


# ---- the shard image (the format both tiers share) ------------------

def test_shard_roundtrip_mixed_pytree():
    """Tensor and numpy leaves, scalars and strings: both packages'
    images restore the same values; kinds survive (tensors come back
    as tensors, numpy as numpy)."""
    rng = np.random.default_rng(SEED)
    w = rng.standard_normal((4, 8)).astype(np.float32)
    opt = np.arange(10, dtype=np.int32)

    def payload(leaf):
        return {"step": 7, "w": leaf(w), "opt": [opt, ("adam", 0.9)],
                "note": "hello"}

    import jax.numpy as jnp
    out = shard.loads(shard.dumps(payload(torch.from_numpy)), None)
    ref = ref_shard.loads(ref_shard.dumps(payload(jnp.asarray)), None)
    for got in (out, ref):
        assert got["step"] == 7 and got["note"] == "hello"
        assert got["opt"][1] == ("adam", 0.9)
        assert isinstance(got["opt"][0], np.ndarray)
    assert isinstance(out["w"], torch.Tensor)
    assert _values(out["w"]).tobytes() == np.asarray(ref["w"]).tobytes()
    np.testing.assert_array_equal(out["opt"][0], ref["opt"][0])


def test_shard_numpy_snapshot_at_plan_time():
    for mod in (shard, ref_shard):
        a = np.arange(8.0)
        p = mod.plan({"a": a})
        a[:] = -1.0
        mod.drain(p.shards[0])
        got = np.frombuffer(p.shards[0].host.tobytes(), dtype=a.dtype)
        np.testing.assert_array_equal(got, np.arange(8.0))


def test_shard_loads_detects_corruption():
    for mod, leaf in ((shard, torch.arange(64.0)),
                      (shard, np.arange(64.0)),
                      (ref_shard, np.arange(64.0))):
        blob = bytearray(mod.dumps({"w": leaf}))
        blob[-3] ^= 0xFF
        with pytest.raises(ValueError, match="CRC mismatch"):
            mod.loads(bytes(blob), None)


def test_divergence_tensor_leaves_snapshotted_at_plan():
    """Checkpoint, write to the tensor in place, restore: the values
    from before the write — through the plan/drain split, the buddy
    image and the filesystem payload encoding alike.  (The reference
    holds jax leaves by reference: they cannot be written.)"""
    t = torch.arange(16, dtype=torch.float32)
    p = shard.plan({"t": t})
    blob_before = shard.dumps({"t": t})
    enc = cr._encode({"t": t})
    t.mul_(-1.0)  # in place, after the snapshot
    shard.drain(p.shards[0])
    want = np.arange(16, dtype=np.float32).tobytes()
    assert p.shards[0].host.tobytes() == want
    assert _values(shard.loads(blob_before, None)["t"]).tobytes() == want
    assert _values(cr._decode(enc, None)["t"]).tobytes() == want


def test_divergence_tensor_dtype_tags():
    """A tensor shard's tag is the torch dtype's name; bfloat16, which
    numpy cannot name, bool and int64 round-trip bit for bit onto the
    caller's device: a torch.device, a LogicalDevice (its real
    device) or None (the CPU)."""
    rng = np.random.default_rng(SEED)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    leaves = {
        "bf16": torch.from_numpy(f32).to(torch.bfloat16),
        "bool": torch.from_numpy(rng.random(7) > 0.5),
        "i64": torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, 9)),
        "f64_0d": torch.tensor(3.25, dtype=torch.float64),
        "empty": torch.empty((0, 3), dtype=torch.int16),
        "strided": torch.from_numpy(f32).t(),   # not contiguous
    }
    p = shard.plan(leaves)
    assert [s.dtype for s in p.shards] == [
        "bfloat16", "bool", "int64", "float64", "int16", "float32"]
    blob = shard.dumps({"nested": [leaves, (1, leaves["bf16"])]})
    for dev in (CPU, LogicalDevice(CPU, 3), None):
        out = shard.loads(blob, dev)
        got = out["nested"][0]
        for k, v in leaves.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            assert got[k].device == CPU, k
            assert torch.equal(got[k], v), k
        assert torch.equal(out["nested"][1][1], leaves["bf16"])
    # the bytes ride as uint8 views: bf16 is the top half of its f32
    raw = leaves["bf16"].view(torch.int16).numpy().astype(np.uint16)
    top = (f32.view(np.uint32) >> 16).astype(np.uint16)
    assert np.max(np.abs(raw.astype(np.int32) - top)) <= 1


def test_cpu_snapshot_stage_is_aligned():
    """A CPU tensor's snapshot lands in the staging module's aligned
    numpy buffer (its second user after the hierarchical hop)."""
    stage, ev = shard.snapshot(torch.arange(33, dtype=torch.int8))
    assert ev is None and isinstance(stage, np.ndarray)
    assert stage.ctypes.data % STAGE_ALIGN == 0
    assert stage.tobytes() == bytes(range(33))


def test_pml_capture_hooks():
    """The pml's C/R hooks after an unreceived eager send: the bookmark
    counters, ``cr_capture`` (the parked message's bytes; the
    barrier's internal-tag traffic is not snapshotted) and
    ``cr_capture_lenient`` (its (cid, src, seq)); ``ft_reset`` leaves no
    matching or sequence state.  The thread world's barrier meets in
    coll/sm and drives no pml progress, so rank 1 probes (without
    receiving) until the message has arrived before it snapshots: the
    values are held to the hooks' contract."""
    def fn(comm):
        if comm.rank == 0:
            comm.Send(np.arange(3.0), dest=1, tag=4)
        comm.Barrier()
        if comm.rank == 1:
            comm.Probe(source=0, tag=4)
        pml = comm.state.pml
        out = (dict(pml.cr_sent), dict(pml.cr_arrived),
               pml.cr_pending_sends(), pml.cr_capture(),
               (0, 0, 0) in pml.cr_capture_lenient())
        comm.Barrier()
        if comm.rank == 1:
            comm.Recv(np.empty(3), source=0, tag=4)
        comm.Barrier()
        pml.ft_reset()
        assert not pml._unexpected and not pml._send_seq \
            and not pml._next_seq and not pml.cr_sent
        return out

    r = run_ranks(2, fn)
    assert r[0] == ({1: 1}, {}, 0, [], False)
    assert r[1] == ({}, {0: 1}, 0, [(0, 0, 4, 24, "bytes",
                                     np.arange(3.0).tobytes())], True)
