"""Whether the card reads a 32-byte sector that a kernel writes only in
part: device time of stores that fill whole sectors against stores that
fill half of each, beside K5's 8 MiB config 5 row.

    python3 -m ompi_tpu_torch.tools.sector_probe [--iters 50]

Rows, float64, each the device time of one call (CUDA events around a
replayed CUDA graph, cold: the calls rotate through 256 MiB of input
sets, past the 50 MiB L2):
- ``fill_16MiB``: a contiguous 16 MiB write, whole sectors;
- ``copy_16MiB``: a contiguous 16 MiB read and 16 MiB write;
- ``fill_half_16MiB``: every other 8-byte element of a 16 MiB span,
  8 MiB written, half of each sector;
- ``copy_8MiB``: a contiguous 8 MiB read and 8 MiB write;
- ``k5_unpack_8MiB``: K5 in run mode on config 5's whole
  2**20-element result: 8 MiB read, the same half-sector stores.

If ``fill_half_16MiB`` takes about ``copy_16MiB``'s time and not
``fill_16MiB``'s, a half-written sector costs a read of the sector as
well as its write, and K5's 8 MiB row moves 40 MiB (8 read, 16 read,
16 written) where its function needs 24.  The probe's own stores are
PyTorch's (``fill_``, ``copy_``): it measures the memory, not a port.
The last line is one JSON object of the rows' ms and the card.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .tile_sweep import COLD, MIB, _time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=50)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sector_probe: no CUDA card")
    from ompi_tpu_torch.kernels import build, index
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    build.build_all(["index"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    n = 1 << 20  # float64 elements: 8 MiB

    def zeros(nel):
        return torch.zeros(nel, dtype=torch.float64, device=dev)

    def scatter_set(i):
        return (torch.full((n,), float(i + 1), dtype=torch.float64,
                           device=dev),
                index.IndexVector(np.arange(0, 2 * n, 2), dev),
                zeros(2 * n))

    rows = {  # name -> (bytes of a set, make(i), fn)
        "fill_16MiB": (16 * MIB, lambda i: zeros(2 * n),
                       lambda t: t.fill_(1.0)),
        "copy_16MiB": (32 * MIB, lambda i: (zeros(2 * n), zeros(2 * n)),
                       lambda s: s[1].copy_(s[0])),
        "fill_half_16MiB": (16 * MIB, lambda i: zeros(2 * n),
                            lambda t: t.view(n, 2)[:, 0].fill_(1.0)),
        "copy_8MiB": (16 * MIB, lambda i: (zeros(n), zeros(n)),
                      lambda s: s[1].copy_(s[0])),
        "k5_unpack_8MiB": (24 * MIB, scatter_set,
                           lambda s: index.index_scatter(*s)),
    }
    ms = {}
    for name, (nbytes, make, fn) in rows.items():
        sets = [make(i) for i in range(-(-COLD // nbytes))]
        ms[name] = _time(fn, sets, max(args.iters, len(sets)))
        print(f"[probe] {name}: {ms[name]:.4f} ms", flush=True)
        del sets
    print(json.dumps({"ms": ms, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
