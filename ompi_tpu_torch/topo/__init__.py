"""Process topologies (ref: ompi/mca/topo, ompi/mpi/c/cart_*.c,
graph_*.c, dist_graph_*.c, neighbor_*.c).

Cartesian, graph, and distributed-graph topologies attached to a
communicator (`comm.topo`, like the reference's `comm->c_topo`), and
the MPI-3 neighbor collectives defined over them.

Device mapping: a cartesian topology over device-owning ranks is the
halo substrate — ``Communicator.shift_arr`` runs a dimension shift as
the comm's ``ppermute_arr`` and ``neighbor_allgather_arr`` as one
device collective, so neighbour exchanges stay on the devices.
"""

from ompi_tpu_torch.topo.topo import (  # noqa: F401
    CART, GRAPH, DIST_GRAPH, UNDEFINED_TOPO,
    CartTopo, GraphTopo, DistGraphTopo,
    dims_create, cart_create, graph_create,
    dist_graph_create_adjacent, cart_sub,
)
from ompi_tpu_torch.topo import neighbor  # noqa: F401
