"""Chunked cross-process device-tensor rendezvous: a large tensor must
stream in bounded chunks (peak host staging <= (depth + 2) chunks),
never as one giant pickled frame (ref: pml_ob1_sendreq.c:404-453
pipelined schedule; the port of the reference's
tests/_devp2p_big_prog.py).

Run (two process ranks, each its own simulated node, so btl/tcp
carries the pull):

    python -m ompi_tpu_torch.tools.mpirun -np 2 --simulate-nodes 2 \\
        ompi_tpu_torch/examples/devp2p_big.py --mb 256 --device auto

``--device auto`` (the default) puts rank r's tensor on card r % count
(no card: the rank raises), ``cpu`` on the CPU.  Rank 0 sends ``--mb``
MiB of float32 ``arange`` to rank 1 and overwrites its tensor right
after ``send_arr`` returns (the snapshot rule: the overwrite must not
reach the receiver); rank 1 checks every byte.  Each rank prints one JSON
line: its btl to the peer, the seconds of its side of the transfer
(sender: send_arr until the pull drained; receiver: recv_arr with the
device synchronised), and the sender's max_staged_bytes and bound or
the receiver's verdict.
"""
import json
import os
import sys
import time

import torch

import ompi_tpu_torch
from ompi_tpu_torch.btl import tpu
from ompi_tpu_torch.mca.params import registry


def arg(name: str, default: str) -> str:
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv \
        else default


MB = 1024 * 1024
n_mb = int(arg("--mb", "48"))
choice = arg("--device", "auto")
if choice == "cpu":
    dev = torch.device("cpu")
elif choice == "auto":
    if not torch.cuda.is_available():
        raise RuntimeError("devp2p_big --device auto needs a CUDA card")
    dev = torch.device("cuda", int(os.environ.get("TPUMPI_RANK", "0"))
                       % torch.cuda.device_count())
else:
    raise ValueError(f"--device {choice!r}: auto or cpu")
comm = ompi_tpu_torch.init(device=dev)
chunk = registry.get("btl_tpu_chunk_bytes")
n = n_mb * MB // 4  # float32 elements; >> chunk (4 MiB)


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def want():
    return torch.arange(n, dtype=torch.float32, device=dev).reshape(4, -1)


out = {"rank": comm.rank, "mb": n_mb, "device": str(dev),
       "btl": comm.state.pml.endpoints[1 - comm.rank].btl.name}
if comm.rank == 0:
    x = want()
    sync()
    comm.Barrier()
    eng = tpu._engine(comm.state)
    t0 = time.perf_counter()
    comm.send_arr(x, 1, tag=3)
    x.fill_(-1.0)
    # service pulls until the transfer drains
    deadline = time.monotonic() + 300
    while (eng.pending or eng._inflight) and time.monotonic() < deadline:
        comm.state.progress.progress()
        comm.state.progress.idle_tick()
    out["seconds"] = time.perf_counter() - t0
    assert not eng.pending, "transfer never drained"
    depth = registry.get("btl_tpu_pipeline_depth")
    out["staged"] = eng.max_staged_bytes
    out["bound"] = (depth + 2) * chunk
    out["chunks"] = -(-n * 4 // chunk)
    assert 0 < out["staged"] <= out["bound"], out
    comm.Barrier()
else:
    comm.Barrier()
    t0 = time.perf_counter()
    got = comm.recv_arr(0, tag=3)
    sync()
    out["seconds"] = time.perf_counter() - t0
    ref = want()
    out["exact"] = bool(isinstance(got, torch.Tensor)
                        and got.device == ref.device
                        and torch.equal(got, ref))
    del got, ref
    assert out["exact"], "received bytes differ from the sender's"
    comm.Barrier()
sys.stdout.write(json.dumps(out) + "\n")
sys.stdout.flush()
ompi_tpu_torch.finalize()
