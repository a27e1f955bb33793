"""The tiered checkpoint engine on a card (gpu-marked: skips where no
card is present).  No JAX here, so the file runs on a machine without
it: ``python -m pytest tests/test_torch_ckpt_card.py -m gpu``.

8 rank-threads on the card (coll/hbm) checkpoint a 4 MiB float32 card
tensor through ``cr.ckpt`` and overwrite it in place right after the
call, while its epoch's drain is pending; the flush commits and the
restore gives the bytes the tensor held at the call, on the card (the
snapshot is a queued device-to-host copy into a pinned stage, ordered
before the overwrite on the rank's stream).  Tolerance: bytes.
"""

import hashlib

import pytest
import torch

from ompi_tpu_torch.cr import ckpt
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks


@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the snapshot is a queued "
                    "device-to-host copy there)")
    return torch.device("cuda", 0)


def _sha(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


@pytest.mark.gpu
def test_card_tensor_overwritten_after_checkpoint_restores_its_bytes(
        tmp_path, cuda_device):
    n = 1 << 20
    store = str(tmp_path)

    def fn(comm):
        x = (torch.arange(n, device=cuda_device) % 89).float() + comm.rank
        t = comm.allreduce_arr(x, port_op.SUM)
        ckpt.checkpoint(comm, {"t": t}, store_dir=store)
        pending = len(ckpt._engine(comm.state).pending.queue)
        keep = t.clone()
        t.fill_(-1.0)
        ckpt.flush(comm)
        out = ckpt.restore(comm, store_dir=store)["t"]
        return (pending, out.device == cuda_device, _sha(out) == _sha(keep),
                _sha(keep))

    out = run_ranks(8, fn, device_map=lambda r: cuda_device)
    assert all(p >= 1 and on and same for p, on, same, _ in out)
    assert len({d for _, _, _, d in out}) == 1
