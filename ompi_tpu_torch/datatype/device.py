"""On-device datatype packing: the descriptor program as ONE index
gather on the card.

A committed datatype's run descriptors (engine.py) are compiled once
into an element-index vector, and packing a card-resident buffer
becomes ``out[i] = buf[idx[i]]`` — K4 ``index_gather``
(kernels/index.py; reference counterpart: the convertor pack loop
feeding coll buffers, opal/datatype/opal_convertor.h:131-137, which
walks descriptors element-wise on the host CPU).  Unpack is the
mirrored scatter, K5 ``index_scatter``, which reads no index where the
cached ``IndexVector`` holds a run table (config 5's vector: one run).

The fused mesh batch's glue (coll/fusion) lives here too, as in the
reference: ``segment_offsets`` (the static offset table of a flat
concatenation), ``pack_segments`` (one rank's slots into one buffer,
K7 ``slot_pack``) and ``unpack_segments`` (views back out).

Eligibility: every run must use the same primitive dtype as the
buffer, with displacements/strides that are whole elements — exactly
the shapes MPI vector/indexed/subarray types of one base type produce.
Mixed-type structs stay with the host convertor.

One intended divergence from the reference: ``device_unpack`` writes
the unpacked elements into ``out`` in place and returns it, as MPI
unpack writes the receive buffer (the reference, on immutable jax
arrays, returns a new array and leaves ``out`` as it was).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch.kernels import index as _k
from ompi_tpu_torch.kernels import mesh as _mesh

from .engine import Datatype

# (datatype id, count) -> (index vector, base numpy dtype), host-side
_idx_cache: dict = {}
# (datatype id, count, device) -> IndexVector on that device
_dev_cache: dict = {}


def _runs_index(datatype: Datatype, count: int):
    """(element index vector, base dtype) or None; cached."""
    key = (datatype.id, count)
    hit = _idx_cache.get(key)
    if hit is not None:
        return hit
    runs = datatype.runs_for_count(count)
    if not runs:
        return None
    item = runs[0].dtype.itemsize
    chunks = []
    for r in runs:
        if r.dtype != runs[0].dtype:
            return None  # mixed primitive types: host convertor
        if r.disp % item or r.stride % item:
            return None  # sub-element displacement: host convertor
        base = r.disp // item
        stride = r.stride // item
        # (nblocks, count) element grid -> flat packed order
        grid = (base
                + stride * np.arange(r.nblocks, dtype=np.int64)[:, None]
                + np.arange(r.count, dtype=np.int64)[None, :])
        chunks.append(grid.reshape(-1))
    idx = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
    if (idx < 0).any():
        return None  # negative displacement: host convertor owns it
    _idx_cache[key] = hit = (idx, runs[0].dtype)
    return hit


def element_indices(datatype: Datatype, count: int) -> Optional[np.ndarray]:
    """Element indices (into a flat element-typed buffer view) whose
    gather equals the datatype's packed stream for ``count`` elements,
    or None when the datatype is not device-packable.  Cached per
    (datatype id, count) — index construction is host-side and O(n),
    the gather on the card is the per-call cost."""
    hit = _runs_index(datatype, count)
    return None if hit is None else hit[0]


def _index(datatype: Datatype, count: int, device) -> _k.IndexVector:
    """The index vector on ``device``, cached per (datatype id, count,
    device); raises when the datatype is not device-packable."""
    key = (datatype.id, count, str(device))
    iv = _dev_cache.get(key)
    if iv is None:
        hit = _runs_index(datatype, count)
        if hit is None:
            raise ValueError(
                f"datatype {datatype.name or datatype.id} is not "
                f"device-packable (mixed types or sub-element layout)")
        iv = _dev_cache[key] = _k.IndexVector(hit[0], device)
    return iv


def _check_base(datatype: Datatype, count: int, *ts: torch.Tensor) -> None:
    base = _idx_cache[(datatype.id, count)][1]
    for t in ts:
        if convert.numpy_dtype(t.dtype) != base:
            raise ValueError(f"buffer dtype {t.dtype} does not match "
                             f"datatype base {base}")


def device_pack(datatype: Datatype, count: int, arr: torch.Tensor
                ) -> torch.Tensor:
    """Pack a card-resident tensor through the datatype: one index
    gather.  ``arr`` is the flat element-typed buffer the datatype
    addresses; returns the packed stream, a new 1-D tensor."""
    iv = _index(datatype, count, arr.device)
    _check_base(datatype, count, arr)
    return _k.index_gather(arr.reshape(-1), iv)


def device_unpack(datatype: Datatype, count: int, packed: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Scatter a packed stream back through the datatype into ``out``
    (a contiguous element-typed tensor), in place; returns ``out``."""
    iv = _index(datatype, count, out.device)
    _check_base(datatype, count, packed, out)
    if not out.is_contiguous():
        raise ValueError("device_unpack: out must be contiguous (it is "
                         "written in place)")
    _k.index_scatter(packed.reshape(-1), iv, out.view(-1))
    return out


def is_device_packable(datatype: Datatype, count: int) -> bool:
    return element_indices(datatype, count) is not None



# ---------------------------------------------------------------------------
# segment packing for fused collectives (coll/fusion): N small payloads
# ride one flat buffer; the offset table is static per batch signature
# ---------------------------------------------------------------------------

def segment_offsets(shapes):
    """Offset table for a flat concatenation of tensors with the given
    shapes: (offsets, lengths, total_elements); a 0-d shape counts one
    element."""
    offs, lens = [], []
    total = 0
    for sh in shapes:
        n = 1
        for d in sh:
            n *= int(d)
        offs.append(total)
        lens.append(n)
        total += n
    return tuple(offs), tuple(lens), total


def pack_segments(tensors, zero=None) -> torch.Tensor:
    """Flatten and concatenate one device's contiguous tensors into
    one new buffer in ONE launch (K7 ``slot_pack``); ``zero[i]`` writes
    tensor i's span as zeros (a non-root bcast slot of a fused batch)."""
    return _mesh.slot_pack([t.reshape(-1) for t in tensors], zero)


def unpack_segments(flat: torch.Tensor, shapes):
    """Mirror of pack_segments: views of ``flat`` in the original
    shapes (no copy)."""
    offs, lens, _ = segment_offsets(shapes)
    return [flat[o:o + n].view(sh) for o, n, sh in zip(offs, lens, shapes)]
