"""B14's process half (btl/tpu.py ``TpuRndvEngine``, ``_pull_transfer``
and ``DeviceArrayPayload``'s pickling) and the cross-process staging of
``HostArrModule`` — the analog of the process cases of
tests/test_device_p2p.py, through the port's mpirun.  The CPU stands in
for the card (``--devices cpu``), and a counting stub on
``runtime.staging.aligned_empty`` shows every device byte crossing the
host goes through a stage; the pinned half of that rule (a card's stage
is pinned or the call raises) is held with a meta tensor standing in
for a card's, as tests/test_torch_hier.py does for the leader hop."""

import json
import os
import pickle
import textwrap

import numpy as np
import pytest
import torch

from ompi_tpu_torch.btl import tpu as tpumod
from ompi_tpu_torch.coll import device
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import mpirun_run, run_ranks

CHUNK = 65536

# one rank program for the cross-process cases: rank 0 sends rank
# size-1 a chunked tensor and a small one and overwrites both right
# after send_arr; the world allreduces a tensor; every stage allocation
# is counted, and both ends report the btl that carries their traffic.
# Its arguments: the element count, and the device of a process rank
# (an app shell's rank-threads get theirs from --devices)
PROG = textwrap.dedent("""
    import json, sys, time
    import numpy as np
    import torch
    from ompi_tpu_torch.runtime import staging
    calls = []
    _empty = staging.aligned_empty

    def counting(nbytes, device="cpu"):
        calls.append(int(nbytes))
        return _empty(nbytes, device)

    staging.aligned_empty = counting
    takes = []
    _take = staging.MirrorPool.take

    def counted_take(self, nbytes):
        import threading
        takes.append((threading.current_thread().name, int(nbytes)))
        return _take(self, nbytes)

    staging.MirrorPool.take = counted_take
    import ompi_tpu_torch
    from ompi_tpu_torch.btl import tpu
    from ompi_tpu_torch.mca.params import registry
    from ompi_tpu_torch.op import op
    comm = ompi_tpu_torch.init(
        device=torch.device(sys.argv[2]) if len(sys.argv) > 2 else None)
    dev = comm.device
    n = int(sys.argv[1])
    res = {"rank": comm.rank, "device": str(dev)}
    if comm.rank == 0:
        big = torch.arange(n, dtype=torch.float32, device=dev) \\
            if dev is not None else np.arange(n, dtype=np.float32)
        small = (torch.arange(10, device=dev) if dev is not None
                 else np.arange(10)) * 3
        comm.send_arr(big, comm.size - 1, tag=3)
        comm.send_arr(small, comm.size - 1, tag=4)
        big[:] = -1      # the receiver must still see the old bytes
        small[:] = -1
        eng = tpu._engine(comm.state)
        deadline = time.monotonic() + 60
        while (eng.pending or eng._inflight) and time.monotonic() < deadline:
            comm.state.progress.progress()
            comm.state.progress.idle_tick()
        res["drained"] = not eng.pending
        res["staged"] = eng.max_staged_bytes
        res["bound"] = (registry.get("btl_tpu_pipeline_depth") + 2) \\
            * registry.get("btl_tpu_chunk_bytes")
    elif comm.rank == comm.size - 1:
        got = comm.recv_arr(0, tag=3)
        small = comm.recv_arr(0, tag=4)
        res["big_type"] = type(got).__name__
        a = np.asarray(got.cpu() if isinstance(got, torch.Tensor) else got)
        res["big_exact"] = a.tobytes() == \\
            np.arange(n, dtype=np.float32).tobytes()
        s = np.asarray(small.cpu() if isinstance(small, torch.Tensor)
                       else small)
        res["small"] = s.tolist()
    if comm.rank in (0, comm.size - 1):
        peer = comm.size - 1 - comm.rank
        res["btl"] = comm.state.pml.endpoints[peer].btl.name
    comm.Barrier()
    import threading
    me = threading.current_thread().name
    before = len([t for t in takes if t[0] == me])
    x = torch.full((1000,), float(comm.rank + 1), device=dev) \\
        if dev is not None else np.full(1000, comm.rank + 1.0)
    y = comm.allreduce_arr(x, op.SUM)
    res["allreduce"] = float(np.asarray(
        y.cpu() if isinstance(y, torch.Tensor) else y)[0])
    res["allreduce_type"] = type(y).__name__
    res["allreduce_stages"] = [nb for t, nb in takes if t == me][before:]
    res["stage_calls"] = len(calls)
    res["takes"] = len([t for t in takes if t[0] == me])
    sys.stdout.write("RES " + json.dumps(res) + "\\n")
    sys.stdout.flush()
    ompi_tpu_torch.finalize()
""")


def launch(tmp_path, np_, n, rpp=None, devices=None, btl=None, dev=()):
    prog = tmp_path / "p2p_prog.py"
    prog.write_text(PROG)
    mca = [("btl_tpu_chunk_bytes", CHUNK)]
    if btl:
        mca.append(("btl", btl))
    r = mpirun_run(np_, str(prog), str(n), *dev, rpp=rpp, devices=devices,
                   mca=mca, timeout=150, job_timeout=120)
    assert r.returncode == 0, r.stderr.decode()[-3000:]
    res = [json.loads(ln[4:]) for ln in r.stdout.decode().splitlines()
           if ln.startswith("RES ")]
    assert len(res) == np_, r.stdout.decode()
    return {d["rank"]: d for d in res}


def test_host_staged_across_processes(tmp_path):
    """Process ranks (no device): the small payload crosses as numpy
    through the wire codec's pickle, the chunked one by the pull; the
    receiver gets numpy with the sender's bytes at the call."""
    res = launch(tmp_path, 2, 3 * CHUNK // 4 + 1)
    # process ranks of one host: btl/shm carries their traffic
    assert res[0]["btl"] == res[1]["btl"] == "shm"
    assert res[1]["small"] == [3 * k for k in range(10)]
    assert res[1]["big_exact"] and res[1]["big_type"] == "ndarray"
    assert res[0]["drained"] and 0 < res[0]["staged"] <= res[0]["bound"]
    assert res[0]["allreduce"] == res[1]["allreduce"] == 3.0
    # host-only ranks stage nothing through runtime/staging
    assert res[0]["stage_calls"] == res[1]["stage_calls"] == 0
    assert res[0]["takes"] == res[1]["takes"] == 0


@pytest.mark.parametrize("btl", [None, "self,inproc,tcp"])
def test_chunked_transfer_bounded_staging(tmp_path, btl):
    """A tensor of 16 chunks crosses two app shells by the chunked
    pull, with the default btl selection and with tcp named alone:
    exact bytes, the sender's staging bounded by (depth + 2) chunks,
    and the sender's overwrite right after send_arr never reaches the
    receiver (the snapshot).  Each app shell is a node of its own, as
    in the reference (mpirun gives each its TPUMPI_NODE), so btl/tcp
    carries the traffic between the shells under either selection;
    test_chunked_transfer_between_process_ranks holds btl/shm."""
    n = 16 * CHUNK // 4 + 5  # a ragged last chunk
    res = launch(tmp_path, 4, n, rpp=2, devices="cpu", btl=btl)
    s, r = res[0], res[3]
    assert s["btl"] == r["btl"] == "tcp", (s, r)
    assert s["drained"] and 0 < s["staged"] <= s["bound"], s
    assert r["big_exact"] and r["big_type"] == "Tensor"
    assert r["small"] == [3 * k for k in range(10)]
    # the world allreduce of a tensor across the shells: staged in
    # (input) and out (result) on every rank, the value exact
    for d in res.values():
        assert d["allreduce"] == 10.0 and d["allreduce_type"] == "Tensor"
        assert d["allreduce_stages"] == [4000, 4000], d
    # the pull staged every chunk on both sides: 17 takes of the
    # shared pool on the sender and the receiver (some of them the
    # pool's fresh aligned_empty stages)
    assert s["takes"] >= 17 + 2 and r["takes"] >= 17 + 2
    assert s["stage_calls"] >= 1 and r["stage_calls"] >= 1


@pytest.mark.parametrize("btl,carrier", [(None, "shm"),
                                         ("self,tcp", "tcp")])
def test_chunked_transfer_between_process_ranks(tmp_path, btl, carrier):
    """Two process ranks of one host, each given the CPU as its device:
    the chunked pull of a tensor of 16 chunks over btl/shm (the default
    selection: both ranks are on node 0) and over btl/tcp named alone —
    exact bytes, bounded staging, the snapshot, and the world
    allreduce_arr staged in and out on both ranks."""
    n = 16 * CHUNK // 4 + 5
    res = launch(tmp_path, 2, n, btl=btl, dev=("cpu",))
    s, r = res[0], res[1]
    assert s["btl"] == r["btl"] == carrier, (s, r)
    assert s["drained"] and 0 < s["staged"] <= s["bound"], s
    assert r["big_exact"] and r["big_type"] == "Tensor"
    assert r["small"] == [3 * k for k in range(10)]
    for d in res.values():
        assert d["allreduce"] == 3.0 and d["allreduce_type"] == "Tensor"
        assert d["allreduce_stages"] == [4000, 4000], d


def test_chunked_header_checkpoint_roundtrip():
    """A not-yet-received chunked transfer survives capture/restore:
    the receiver snapshots the header, the sender snapshots the parked
    data, and fresh ids never collide with restored ones."""
    from ompi_tpu_torch.pml.ob1 import MATCH_OBJ, UnexpectedMsg

    def fn(comm):
        if comm.rank == 0:
            eng = tpumod._engine(comm.state)
            flat = torch.arange(5000, dtype=torch.float64)
            xid = eng.begin_send(flat)
            cap = eng.cr_capture()
            assert len(cap) == 1 and cap[0][0] == xid
            assert np.array_equal(cap[0][1], np.arange(5000.0))
            eng.pending.clear()
            eng.cr_restore(cap)
            assert xid in eng.pending
            assert eng.begin_send(flat) > xid
            eng.pending.clear()
        else:
            pml = comm.state.pml
            hdr = tpumod._XferHdr(7, (10, 500), "torch.float64", 40000,
                                  registry.get("btl_tpu_chunk_bytes"))
            pml._unexpected.setdefault(comm.cid, []).append(
                UnexpectedMsg(MATCH_OBJ, comm.cid, 0, 4, 0,
                              len(hdr), None, hdr))
            msgs = pml.cr_capture()
            assert "xferhdr" in [m[4] for m in msgs]
            pml._unexpected[comm.cid].clear()
            pml.cr_restore(msgs)
            m = pml._unexpected[comm.cid][0]
            assert isinstance(m.payload, tpumod._XferHdr)
            assert m.payload.shape == (10, 500)
            pml._unexpected[comm.cid].clear()
        comm.Barrier()
        return True

    assert all(run_ranks(2, fn))


@pytest.mark.parametrize("dtype", [torch.float32, torch.int16,
                                   torch.bfloat16, torch.complex64])
def test_payload_pickles_host_bytes_never_a_storage(dtype):
    """The wire codec's pickle of a payload holding a tensor carries
    host bytes: no torch storage or rebuild hook in the frame, and the
    bytes unpickle to the tensor's values (numpy where numpy has the
    dtype)."""
    t = (torch.arange(64) - 7).to(dtype).reshape(8, 8)
    blob = pickle.dumps(tpumod.DeviceArrayPayload(t),
                        protocol=pickle.HIGHEST_PROTOCOL)
    for bad in (b"torch._utils", b"_rebuild", b"Storage", b"storage",
                b"torch._tensor"):
        assert bad not in blob, bad
    back = pickle.loads(blob)
    arr = back.arr
    if isinstance(arr, tuple):  # raw bytes + dtype where numpy lacks it
        raw, tdt, shape = arr
        got = torch.frombuffer(bytearray(raw.tobytes()),
                               dtype=torch.uint8).view(tdt).reshape(shape)
    else:
        assert isinstance(arr, np.ndarray)
        from ompi_tpu_torch import convert
        got = convert.to_torch(arr, "cpu")
    assert got.dtype == dtype and torch.equal(got, t)


def test_divergence_card_payload_stages_pinned_or_raises():
    """Pinned divergence: a card tensor's payload is copied into a
    pinned stage before it is pickled; with no pinned allocator (this
    CPU-only build, a meta tensor standing in for a card's) pickling
    raises instead of taking a pageable copy."""
    with pytest.raises(RuntimeError, match="pin"):
        pickle.dumps(tpumod.DeviceArrayPayload(
            torch.ones(1024, device="meta")))


def test_divergence_cross_process_host_module_stages_pinned_or_raises():
    """Pinned divergence: HostArrModule stages a tensor through the
    shared pool only on a communicator that spans processes (a comm
    marked so here stands in for one); a card's stage is pinned or the
    call raises RuntimeError before any byte moves — while on a
    communicator within the process the same tensor is refused
    (NotImplementedError), as test_host_path_refuses_device_tensors
    holds."""
    fb = device._host_arr_fallback()
    y = torch.ones(256, device="meta")
    seen = []

    def fn(comm):
        with pytest.raises(NotImplementedError, match="does not stage"):
            fb.allreduce_arr(comm, y, port_op.SUM)
        comm.__dict__["_spans_procs"] = True
        with pytest.raises(RuntimeError, match="pin"):
            fb.allreduce_arr(comm, y, port_op.SUM)
        # a CPU tensor on the "spanning" comm: staged through numpy
        # stages of the pool, the bytes the plain path gives
        x = torch.arange(256, dtype=torch.int32) + comm.rank
        out = fb.allreduce_arr(comm, x, port_op.SUM)
        seen.append(isinstance(out, torch.Tensor))
        return out.tolist()

    res = run_ranks(2, fn, device_map=lambda r: torch.device("cpu"))
    want = [2 * k + 1 for k in range(256)]
    assert res == [want, want] and all(seen)
