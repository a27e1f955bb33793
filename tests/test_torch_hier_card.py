"""The hierarchical tier's leader hop on a card (gpu-marked: skips
where no card is present).  No JAX here, so the file runs on a machine
without it: ``python -m pytest tests/test_torch_hier_card.py -m gpu``.

On 8 logical devices of the card in two slices of 4, the tier gives the
flat mesh allreduce's bytes (int32 SUM, exact under any order), each
leader's two stages are pinned host memory (the hop's phase spans say
so), and a stage that cannot be pinned raises on the leaders, so the
op fails on every rank instead of falling back to a pageable copy.
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch import convert
# imported for the knobs they register (coll_hier_*, coll_pipeline_*,
# coll_seg_size; trace_*), which the knobs helper saves and restores
from ompi_tpu_torch import trace  # noqa: F401
from ompi_tpu_torch.coll import pipeline  # noqa: F401
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices, run_ranks

SEED = 20261018
HIER = {"coll_pipeline_enable": True, "coll_hier_enable": True,
        "coll_hier_slice_size": 4, "coll_hier_min_bytes": 1024,
        "coll_pipeline_min_bytes": 2048, "coll_seg_size": 4096}


class knobs:
    """Set MCA knobs; restore on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = {k: registry.get(k) for k in self.vals}
        for k, v in self.vals.items():
            registry.set(k, v)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            registry.set(k, v)


# ---- on the card -------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The first card, or a skip: decided when the test runs, never
    when the module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (pinned stages need one)")
    return torch.device("cuda", 0)


TRACE = {"trace_enable": 1, "trace_phase_enable": 1,
         "trace_sample_auto": 0}
HOP = ("ph_hop_d2h", "ph_hop_host", "ph_hop_h2d")


@pytest.mark.gpu
def test_leader_hop_pinned_on_card(cuda_device, monkeypatch):
    """On the card: the tier over 8 logical devices of the card in two
    slices of 4 gives the flat mesh allreduce's bytes (int32 SUM); under
    phase tracing each leader's D2H and H2D spans carry the payload's
    bytes and a pinned stage; a stage that cannot be pinned raises on
    the leaders and the op fails on every rank."""
    n, length = 8, 1 << 16
    rng = np.random.default_rng(SEED + 17)
    xs = [rng.integers(-1000, 1000, length).astype(np.int32)
          for _ in range(n)]

    def fn(comm):
        x = convert.to_torch(xs[comm.rank], comm.device)
        out = comm.allreduce_arr(x, port_op.SUM)
        torch.cuda.synchronize()
        spans = [(e["name"], e["args"].get("nbytes"),
                  e["args"].get("pinned"))
                 for e in comm.state.tracer.snapshot() if e["name"] in HOP]
        return convert.to_numpy(out).tobytes(), spans

    dmap = logical_devices(cuda_device)
    with knobs(dict(HIER, **TRACE)):
        hier = run_ranks(n, fn, device_map=dmap)
    with knobs(dict(HIER, coll_hier_enable=False, **TRACE)):
        flat = run_ranks(n, fn, device_map=dmap)
    assert [o for o, _ in hier] == [o for o, _ in flat]
    assert len({o for o, _ in hier}) == 1
    want = [("ph_hop_d2h", length * 4, 1), ("ph_hop_host", length * 4, None),
            ("ph_hop_h2d", length * 4, 1)]
    assert [s for _, s in hier] == [want if r in (0, 4) else []
                                    for r in range(n)]
    assert all(s == [] for _, s in flat)

    monkeypatch.setattr(torch.Tensor, "is_pinned", lambda self: False)
    with knobs(dict(HIER, **TRACE)):
        with pytest.raises(Exception, match="could not be pinned"):
            run_ranks(n, fn, device_map=dmap, timeout=60)
