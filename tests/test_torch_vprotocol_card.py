"""pml/vprotocol's sender log on a card (gpu-marked: skips where no
card is present).  No JAX here, so the file runs on a machine without
it: ``python -m pytest tests/test_torch_vprotocol_card.py -m gpu``.

Two rank-threads on the card with ``pml_vprotocol pessimist``: rank 0
``send_arr``s a card tensor; the log's snapshot is a D2H queued on the
card's stream into a pinned stage, behind the placement event, and the
payload's event becomes the one after that copy.  The cut is
simulated as in tests/test_torch_vprotocol.py; rank 0 overwrites its
source tensor and rank 1 would own the delivered copy, and the replay
still gives rank 1 the pre-overwrite bytes, on the card, in a tensor
of its own.  A 2-rank thread world with the sender on a side stream
checks the ordering without a device-wide synchronize.  Tolerance:
bytes.
"""

import hashlib

import pytest
import torch

from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.pml import vprotocol
from ompi_tpu_torch.testing import run_ranks


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the log's snapshot is a queued "
                    "device-to-host copy into a pinned stage there)")
    return torch.device("cuda", 0)


@pytest.fixture
def pessimist():
    registry.set("pml_vprotocol", "pessimist")
    yield
    registry.set("pml_vprotocol", "")


def _sha(t):
    return hashlib.sha256(t.detach().cpu().contiguous().numpy()
                          .tobytes()).hexdigest()


@pytest.mark.gpu
@pytest.mark.parametrize("side_stream", [False, True])
def test_card_send_arr_snapshot_and_replay(cuda_device, pessimist,
                                           side_stream):
    n = 1 << 20
    want = _sha((torch.arange(n, device=cuda_device) % 251).float())

    def fn(comm):
        v = vprotocol.find(comm.state.pml)
        base = v._base
        if comm.rank == 0:
            stream = torch.cuda.Stream(cuda_device) if side_stream \
                else torch.cuda.current_stream(cuda_device)
            with torch.cuda.stream(stream):
                x = (torch.arange(n, device=cuda_device) % 251).float()
                comm.send_arr(x, 1, tag=5)
                snap = [e[4] for es in v.log.values() for e in es
                        if e[3] == "obj"][-1]
                pinned = snap.stage.is_pinned()
                comm.Barrier()
                x.fill_(-1.0)  # the sender writes on
                v.replay()
                comm.Barrier()
            return pinned, v.log_bytes

        def mine():
            return [m for m in base._unexpected.get(comm.cid, [])
                    if m.tag == 5 and m.src == 0]
        while not mine():
            comm.state.progress.progress()
        drop = mine()
        base._unexpected[comm.cid] = [
            m for m in base._unexpected[comm.cid] if m not in drop]
        base._replay_want = {(comm.cid, m.src, m.seq) for m in drop}
        comm.Barrier()
        comm.Barrier()
        y = comm.recv_arr(0, tag=5)
        return str(y.device), _sha(y)

    (pinned, logged), (where, got) = run_ranks(
        2, fn, device_map=lambda r: cuda_device)
    assert pinned and logged >= 4 * n
    assert where == str(cuda_device) and got == want
