"""The comparison that decides ``correct``.

What the timed path produced (the outputs each rank kept from the
window) is held against the plain reference (``reference.py``),
recomputed in float64 from the same send buffers, each stamped again
as it was for the op that made the output (``traffic.Stamps``), block
by block so that it fits beside the inputs.  Two numbers are compared,
each with its limit from ``limits/<cell>.json``:

``max_err``   the largest absolute difference between an output element
              and the reference's, over every kept output of every rank,
              the gaps of a receive span included (NaN counts as inf)
``bad``       kept outputs that are absent or have the wrong size or type

``control`` is the reference itself, computed in the next precision
down, standing where the program's outputs stand; it must fail.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from portbench import reference
from portbench.traffic import RECV_FILL, Mix, Stamps

BLOCK = 1 << 24        # elements a reference block
LOWER = {torch.float64: torch.float32, torch.float32: torch.bfloat16}

# one kept output: (rank, buffer, stamp row, the output tensor or None)
Kept = Tuple[int, int, int, Optional[torch.Tensor]]


def _err(out: torch.Tensor, exp: torch.Tensor) -> float:
    d = (out.to(torch.float64) - exp.to(device=out.device,
                                        dtype=torch.float64)).abs()
    d = torch.nan_to_num(d, nan=math.inf)
    return float(d.max()) if d.numel() else 0.0


def compare(mix: Mix, sends: Sequence[Sequence[torch.Tensor]],
            stamps: Sequence[Stamps], kept: Sequence[Kept],
            block: int = BLOCK) -> Dict[str, float]:
    """``sends[r][b]``: rank r's send buffer b (a span for a vector),
    stamped anew here for each kept op; ``kept``: the outputs to judge.
    Returns the numbers compared."""
    nranks = len(sends)
    count, stride = mix.elements, mix.stride
    span = mix.out_elements(nranks) * stride
    bad, worst = 0, 0.0
    # (buffer, stamp row) -> (sources, source offset, length) -> views
    need: Dict[tuple, Dict[tuple, List[torch.Tensor]]] = {}
    for rank, b, row, out in kept:
        if (not isinstance(out, torch.Tensor) or out.dtype != mix.dtype
                or out.dim() != 1 or out.numel() != span):
            bad += 1
            continue
        vals = reference.packed(out, stride)
        if stride > 1:
            gaps = out.view(-1, stride)[:, 1:]
            for a in range(0, gaps.shape[0], block):
                g = gaps[a:a + block]
                worst = max(worst, _err(g, torch.full_like(g, RECV_FILL)))
        group = need.setdefault((b, row), {})
        for seg in reference.plan(mix.kind, rank, nranks, count, mix.root):
            lo, hi, srcs, src_lo = seg
            for a in range(lo, hi, block):
                z = min(hi, a + block)
                group.setdefault((srcs, src_lo + a - lo, z - a),
                                 []).append(vals[a:z])
    for (b, row), group in sorted(need.items()):
        bufs = [s[b] for s in sends]
        for x, st in zip(bufs, stamps):
            st.apply(x, row)
        for (srcs, s0, n), views in group.items():
            exp = reference.expected(bufs, (0, n, srcs, s0), 0, n,
                                     mix.reduce, stride, views[0].device)
            for v in views:
                worst = max(worst, _err(v, exp))
            del exp
    return {"max_err": worst, "bad": float(bad)}


def control_kept(mix: Mix, sends: Sequence[Sequence[torch.Tensor]],
                 stamps: Sequence[Stamps], ranks: Sequence[int],
                 bufs: Sequence[int], devices: Sequence,
                 row: int = 0) -> List[Kept]:
    """The reference computed one precision down, in the program's place:
    rank r's output for buffer b stamped with row ``row``, cast back to
    the mix's type."""
    low = LOWER[mix.dtype]
    out = []
    for b in bufs:
        for s, st in zip(sends, stamps):
            st.apply(s[b], row)
        for r in ranks:
            y = reference.output([s[b] for s in sends], mix.kind, mix.reduce,
                                 r, mix.elements, mix.stride, RECV_FILL,
                                 devices[r], dtype=low, root=mix.root)
            out.append((r, b, row, y.to(mix.dtype)))
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number at or under its limit; a number with no limit, or a
    limit with no number, fails."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in numbers)


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict:
    """The result line's last key: each number beside its limit."""
    return {k: {"value": numbers[k], "limit": limits.get(k)}
            for k in sorted(numbers)}
