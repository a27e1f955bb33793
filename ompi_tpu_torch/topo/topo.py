"""Topology objects + constructors.

Re-design of ompi/mca/topo/base (ref: topo_base_cart_create.c,
topo_base_graph_create.c, topo_base_dist_graph_create.c,
topo_base_cart_sub.c, ompi/mpi/c/dims_create.c).  The reference's
topo component carries per-kind state on the communicator; here a
small Topo object hangs off ``comm.topo`` and the creation functions
return a new communicator (dup-cid collective over the parent).

With ``reorder=True``, cart_create and graph_create order the ranks
by their devices (the treematch analog of the reference package,
ompi_tpu/topo/topo.py:244-260), keyed by ``runtime.init.device_key``
so that logical devices of one card stay distinct; otherwise ranks
keep their order, as the reference's default ``topo/basic`` does.
``CartTopo.device_mesh`` is the members' torch devices in grid order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from ompi_tpu_torch.pml.request import PROC_NULL
from ompi_tpu_torch.runtime.init import device_key

CART = 1
GRAPH = 2
DIST_GRAPH = 3
UNDEFINED_TOPO = -32766


def dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> List[int]:
    """MPI_Dims_create: balanced factorization of nnodes over ndims
    (ref: ompi/mpi/c/dims_create.c).  Nonzero entries in `dims` are
    fixed constraints."""
    out = [0] * ndims if dims is None else list(dims)
    fixed = 1
    for d in out:
        if d < 0:
            raise ValueError("dims entries must be >= 0")
        if d:
            fixed *= d
    if fixed <= 0 or nnodes % fixed:
        raise ValueError(f"cannot factor {nnodes} over fixed dims {out}")
    rem = nnodes // fixed
    free = [i for i, d in enumerate(out) if d == 0]
    if not free:
        if rem != 1:
            raise ValueError("dims fully fixed but product != nnodes")
        return out
    # greedy balance: prime factors of rem, largest first, each onto
    # the currently-smallest bucket; buckets then sorted non-increasing
    buckets = [1] * len(free)
    n, p = rem, 2
    primes: List[int] = []
    while p * p <= n:
        while n % p == 0:
            primes.append(p)
            n //= p
        p += 1
    if n > 1:
        primes.append(n)
    for f in sorted(primes, reverse=True):
        buckets[buckets.index(min(buckets))] *= f
    buckets.sort(reverse=True)
    for i, idx in enumerate(free):
        out[idx] = buckets[i]
    return out


class CartTopo:
    """Cartesian topology state (ref: mca_topo_base_comm_cart_2_2_0_t)."""

    kind = CART

    def __init__(self, dims: Sequence[int], periods: Sequence[bool],
                 rank: int) -> None:
        self.dims = list(dims)
        self.periods = [bool(p) for p in periods]
        self.ndims = len(self.dims)
        self.nnodes = 1
        for d in self.dims:
            self.nnodes *= d
        self.coords = self.rank_to_coords(rank)
        self._nbr_cache: dict = {}

    # row-major: dimension 0 most significant (MPI semantics)
    def rank_to_coords(self, rank: int) -> List[int]:
        if not 0 <= rank < self.nnodes:
            raise ValueError(
                f"rank {rank} outside cartesian grid of {self.nnodes} "
                f"(MPI_ERR_RANK)")
        coords = [0] * self.ndims
        for d in range(self.ndims - 1, -1, -1):
            coords[d] = rank % self.dims[d]
            rank //= self.dims[d]
        return coords

    def coords_to_rank(self, coords: Sequence[int]) -> int:
        rank = 0
        for d in range(self.ndims):
            c = coords[d]
            if self.periods[d]:
                c %= self.dims[d]
            elif not (0 <= c < self.dims[d]):
                return PROC_NULL
            rank = rank * self.dims[d] + c
        return rank

    def shift(self, dim: int, disp: int, rank: int) -> Tuple[int, int]:
        """MPI_Cart_shift → (rank_source, rank_dest)."""
        coords = self.rank_to_coords(rank)
        src = list(coords)
        dst = list(coords)
        src[dim] -= disp
        dst[dim] += disp
        return self.coords_to_rank(src), self.coords_to_rank(dst)

    def neighbors(self, rank: int) -> List[int]:
        """Neighbor sequence for neighbor collectives (MPI-3 §7.6):
        per dimension, source-direction then dest-direction of a
        +1 shift.  Cached — the topology is immutable and this is the
        halo-exchange hot path."""
        cached = self._nbr_cache.get(rank)
        if cached is not None:
            return cached
        out: List[int] = []
        for d in range(self.ndims):
            s, t = self.shift(d, 1, rank)
            out.extend((s, t))
        self._nbr_cache[rank] = out
        return out

    # in == out for cartesian
    def in_neighbors(self, rank: int) -> List[int]:
        return self.neighbors(rank)

    def out_neighbors(self, rank: int) -> List[int]:
        return self.neighbors(rank)

    def shift_perm(self, dim: int, disp: int, size: int):
        """[(src, dst)] pairs for a whole-comm shift along `dim` —
        feeds comm.ppermute_arr (the device halo path)."""
        perm = []
        for r in range(size):
            _, dst = self.shift(dim, disp, r)
            if dst != PROC_NULL:
                perm.append((r, dst))
        return perm

    def device_mesh(self, comm):
        """The members' torch devices as nested lists shaped like the
        cart dims: rank r's device sits at grid position
        rank_to_coords(r) (with ``reorder=True`` the ranks were already
        ordered by device, so a row-major walk of the grid walks the
        devices in order).  None when the members do not own
        pairwise-distinct devices (by ``device_key``: logical devices
        of one card are distinct) or the grid does not cover the comm.
        Cached on the comm."""
        cached = comm.__dict__.get("_cart_device_mesh")
        if cached is not None:
            return cached or None
        mesh = None
        if self.nnodes == comm.size:
            devs: Optional[list] = []
            keys = set()
            for g in comm.group:
                st = comm._peer_state(g)
                if st is None or st.device is None:
                    devs = None
                    break
                devs.append(st.device)
                keys.add(device_key(st))
            if devs is not None and len(keys) == len(devs):
                mesh = devs
                for d in reversed(self.dims[1:]):
                    mesh = [mesh[i:i + d] for i in range(0, len(mesh), d)]
        comm.__dict__["_cart_device_mesh"] = mesh if mesh is not None \
            else False
        return mesh


class GraphTopo:
    """MPI-1 graph topology: cumulative index + flat edge list
    (ref: topo_base_graph_create.c)."""

    kind = GRAPH

    def __init__(self, index: Sequence[int], edges: Sequence[int]) -> None:
        self.index = list(index)
        self.edges = list(edges)
        self.nnodes = len(self.index)

    def neighbors(self, rank: int) -> List[int]:
        lo = self.index[rank - 1] if rank > 0 else 0
        return self.edges[lo:self.index[rank]]

    def in_neighbors(self, rank: int) -> List[int]:
        return self.neighbors(rank)

    def out_neighbors(self, rank: int) -> List[int]:
        return self.neighbors(rank)


class DistGraphTopo:
    """MPI-2.2 distributed graph: per-rank local sources/destinations
    (ref: topo_base_dist_graph_create.c; adjacent variant keeps the
    lists local — no exchange needed)."""

    kind = DIST_GRAPH

    def __init__(self, sources: Sequence[int], destinations: Sequence[int],
                 sourceweights=None, destweights=None) -> None:
        self.sources = list(sources)
        self.destinations = list(destinations)
        self.sourceweights = list(sourceweights) if sourceweights else \
            [1] * len(self.sources)
        self.destweights = list(destweights) if destweights else \
            [1] * len(self.destinations)

    def in_neighbors(self, rank: int) -> List[int]:
        return self.sources

    def out_neighbors(self, rank: int) -> List[int]:
        return self.destinations


# ---------------------------------------------------------------------------
# constructors (collective over the parent comm)
# ---------------------------------------------------------------------------

def _device_keys(comm) -> Optional[list]:
    """Every member's ``device_key`` in comm rank order, or None when a
    member owns no device."""
    keys = []
    for g in comm.group:
        st = comm._peer_state(g)
        if st is None or st.device is None:
            return None
        keys.append(device_key(st))
    return keys


def cart_create(comm, dims: Sequence[int], periods=None,
                reorder: bool = False):
    """MPI_Cart_create: ranks >= prod(dims) get None (MPI_COMM_NULL)."""
    dims = list(dims)
    n = 1
    for d in dims:
        n *= d
    if n > comm.size:
        raise ValueError(f"cart size {n} exceeds comm size {comm.size}")
    periods = [False] * len(dims) if periods is None else list(periods)
    if len(periods) != len(dims):
        raise ValueError(
            f"periods length {len(periods)} != ndims {len(dims)}")
    key = comm.rank
    if reorder:
        # treematch analog with the device order as the distance
        # metric (ref: ompi/mca/topo/treematch — reorder ranks against
        # the hardware distance): order ranks by device key so
        # row-major grid coordinates walk the devices in order and
        # last-dim neighbors (the hot halo axis) sit on adjacent ones.
        devs = _device_keys(comm)
        if devs is not None and len(set(devs)) == len(devs):
            key = sorted(range(comm.size),
                         key=lambda r: devs[r]).index(comm.rank)
    sub = comm.split(0 if comm.rank < n else UNDEFINED_TOPO, key)
    if sub is None:
        return None
    sub.topo = CartTopo(dims, periods, sub.rank)
    sub.name = f"cart{tuple(dims)}-{sub.cid}"
    return sub


def _graph_bfs_order(n: int, index: Sequence[int],
                     edges: Sequence[int]) -> List[int]:
    """Deterministic BFS linearization of the graph: order[p] is the
    vertex placed at chain position p.  Neighbors in the graph land at
    nearby positions, so when positions follow device ids the hot
    edges ride adjacent chips.  Covers disconnected components by
    restarting from the lowest unvisited vertex."""
    adj: List[List[int]] = []
    prev = 0
    for v in range(n):
        adj.append(sorted(int(e) for e in edges[prev:index[v]]))
        prev = index[v]
    order: List[int] = []
    seen = [False] * n
    for start in range(n):
        if seen[start]:
            continue
        seen[start] = True
        queue = [start]
        while queue:
            v = queue.pop(0)
            order.append(v)
            for w in adj[v]:
                if 0 <= w < n and not seen[w]:
                    seen[w] = True
                    queue.append(w)
    return order


def graph_create(comm, index: Sequence[int], edges: Sequence[int],
                 reorder: bool = False):
    """MPI_Graph_create: nnodes = len(index) participating ranks.

    With ``reorder=True`` the graph is embedded onto the device order
    (same treematch analog as cart_create): a BFS linearization
    assigns each vertex a position, and the member owning the p-th
    device (by device key) becomes vertex order[p], so graph-adjacent
    vertices sit on adjacent devices.  The split key IS the vertex
    id — keys are a permutation of 0..n-1, so the member with key v
    gets new rank v."""
    n = len(index)
    if n > comm.size:
        raise ValueError("graph larger than communicator")
    key = comm.rank
    if reorder and n == comm.size:
        devs = _device_keys(comm)
        if devs is not None and len(set(devs)) == len(devs):
            order = _graph_bfs_order(n, index, edges)
            devpos = sorted(range(comm.size),
                            key=lambda r: devs[r]).index(comm.rank)
            key = order[devpos]
    sub = comm.split(0 if comm.rank < n else UNDEFINED_TOPO, key)
    if sub is None:
        return None
    sub.topo = GraphTopo(index, edges)
    return sub


def dist_graph_create(comm, sources, degrees, destinations,
                      weights=None, reorder: bool = False):
    """MPI_Dist_graph_create (general form, ref:
    ompi/mpi/c/dist_graph_create.c): every rank may declare edges for
    ANY source; the union is distributed by an allgather of the flat
    (src, dst) pairs, then each rank extracts its own adjacency."""
    import numpy as np

    pairs = []
    off = 0
    for i, s in enumerate(sources):
        for _ in range(degrees[i]):
            w = int(weights[off]) if weights is not None else 1
            pairs.append((int(s), int(destinations[off]), w))
            off += 1
    flat = np.array([x for p in pairs for x in p], dtype=np.int64)
    counts = np.zeros(comm.size, dtype=np.int64)
    mine = np.array([flat.size], dtype=np.int64)
    comm.Allgather(mine, counts)
    total = int(counts.sum())
    allflat = np.empty(total, dtype=np.int64)
    displs = [int(counts[:r].sum()) for r in range(comm.size)]
    comm.Allgatherv(flat, allflat, [int(c) for c in counts], displs)
    edges = allflat.reshape(-1, 3)
    me = comm.rank
    # edge multiplicity is significant (MPI-3 §7.5.4): keep duplicates
    ins = sorted((int(s), int(w)) for s, d, w in edges if d == me)
    outs = sorted((int(d), int(w)) for s, d, w in edges if s == me)
    sub = comm.dup()
    sub.topo = DistGraphTopo(
        [s for s, _w in ins], [d for d, _w in outs],
        [w for _s, w in ins] if weights is not None else None,
        [w for _d, w in outs] if weights is not None else None)
    return sub


def dist_graph_create_adjacent(comm, sources, destinations,
                               sourceweights=None, destweights=None,
                               reorder: bool = False):
    """MPI_Dist_graph_create_adjacent: every rank participates; the
    adjacency is purely local so only a dup is collective."""
    sub = comm.dup()
    sub.topo = DistGraphTopo(sources, destinations, sourceweights,
                             destweights)
    return sub


def cart_sub(comm, remain_dims: Sequence[bool]):
    """MPI_Cart_sub: slice the grid, keeping `remain_dims` axes
    (ref: topo_base_cart_sub.c).  Collective over the cart comm."""
    topo = comm.topo
    if topo is None or topo.kind != CART:
        raise ValueError("cart_sub on a non-cartesian communicator")
    keep = [bool(k) for k in remain_dims]
    if len(keep) != topo.ndims:
        raise ValueError("remain_dims length mismatch")
    # color = coordinates of dropped dims; key = rank (keeps row-major
    # order of kept dims within each slice)
    color = 0
    for d in range(topo.ndims):
        if not keep[d]:
            color = color * topo.dims[d] + topo.coords[d]
    sub = comm.split(color, comm.rank)
    new_dims = [topo.dims[d] for d in range(topo.ndims) if keep[d]]
    new_periods = [topo.periods[d] for d in range(topo.ndims) if keep[d]]
    if not new_dims:
        new_dims, new_periods = [1], [False]
    sub.topo = CartTopo(new_dims, new_periods, sub.rank)
    return sub


def slice_groups(comm, slice_size: int = 0) -> List[List[int]]:
    """Partition comm ranks into hardware 'slices' for the
    hierarchical collective tier: ranks inside a group share fast
    device interconnect; groups talk over the host path.

    ``slice_size > 0`` forces consecutive-rank blocks of that size
    (explicit shaping for tests and odd deployments).  Auto mode
    groups by the device's ``slice_index`` attribute when the runtime
    exposes one, else by the modex ``node_id`` each rank published at
    init, else a single group (no hierarchy).  Keys feed a
    first-appearance ordering, so every member — walking the same
    group list against the same modex data — derives the identical
    partition: divergence here would split the comm across different
    algorithm tiers, i.e. deadlock."""
    if slice_size and slice_size > 0:
        return [list(range(lo, min(lo + slice_size, comm.size)))
                for lo in range(0, comm.size, slice_size)]
    keys: List[object] = []
    for g in comm.group:
        k: object = None
        st = comm._peer_state(g)
        if st is not None and st.device is not None:
            k = getattr(st.device, "slice_index", None)
        if k is None:
            try:
                k = comm.state.rte.modex_get(g, "node_id")
            except (KeyError, LookupError, AttributeError):
                k = None
        keys.append(k)
    if any(k is None for k in keys):
        return [list(range(comm.size))]
    groups: dict = {}
    for r, k in enumerate(keys):
        groups.setdefault(k, []).append(r)
    return list(groups.values())
