"""2-D Jacobi halo exchange on a cartesian process grid — the classic
topo + neighbor-collective workload.  The port's copy of the
reference's ``examples/halo_stencil.py``:

    python -m ompi_tpu_torch.tools.mpirun -np 4 \\
        ompi_tpu_torch/examples/halo_stencil.py

With a device (a hybrid launch, ``--ranks-per-proc N|all``, whose app
shells give each rank-thread one), the east edge also travels as a
tensor on the rank's device: ``sendrecv_arr`` places it on the
neighbour's device directly.
"""

import numpy as np

import ompi_tpu_torch
from ompi_tpu_torch.topo import dims_create


def main() -> None:
    world = ompi_tpu_torch.init()
    dims = dims_create(world.size, 2)
    cart = world.Create_cart(dims, periods=[True, True])
    if cart is None:
        ompi_tpu_torch.finalize()
        return

    n = 8  # local tile edge
    tile = np.full((n, n), float(cart.rank), dtype=np.float64)

    # neighbor_alltoall: per dim, (source-dir block, dest-dir block)
    sbuf = np.stack([
        tile[0],        # north edge → row-source neighbor
        tile[-1],       # south edge → row-dest neighbor
        tile[:, 0],     # west edge
        tile[:, -1],    # east edge
    ]).ravel()
    rbuf = np.zeros_like(sbuf)
    cart.Neighbor_alltoall(sbuf, rbuf)
    halo = rbuf.reshape(4, n)

    interior = tile[1:-1, 1:-1]
    north, south, west, east = halo
    mean_halo = (north.sum() + south.sum() + west.sum() + east.sum()) / (4 * n)

    # device halo: when this rank owns a device (hybrid launch), the
    # same shift runs device-to-device through btl/tpu —
    # sendrecv_arr places the edge on the neighbor's device directly
    if cart.state.device is not None:
        import torch
        left, right = cart.Shift(1, 1)
        dev_edge = torch.as_tensor(tile[:, -1].copy(),
                                   device=cart.state.device)
        dev_halo = cart.sendrecv_arr(dev_edge, right, left, tag=11)
        assert dev_halo.device == cart.state.device, dev_halo.device
        assert float(dev_halo[0]) == float(left), "device halo mismatch"

    print(f"rank {cart.rank} coords {cart.Get_coords()} "
          f"halo-mean {mean_halo:.2f} interior-mean {interior.mean():.2f}",
          flush=True)
    ompi_tpu_torch.finalize()


if __name__ == "__main__":
    main()
