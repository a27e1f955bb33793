"""MPI-3 neighbor collectives over the comm's topology.

Re-design of ompi/mpi/c/neighbor_allgather.c etc. + the coll base
implementations (ref: ompi/mca/coll/base's neighbor paths): post all
irecvs in in-neighbor order, all isends in out-neighbor order, on a
dedicated internal tag — the standard's as-if definition.  Duplicate
neighbor pairs (e.g. a 2-rank periodic ring where both directions hit
the same peer) are disambiguated by the pml's per-(cid, src) sequence
ordering, matching the standard's ordering-based pairing.

PROC_NULL neighbors (non-periodic edges) fall out naturally: the pml
completes sends/recvs to PROC_NULL immediately and leaves the recv
block untouched.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ompi_tpu_torch.coll.buffers import mpi_dtype_of, typed

T_NEIGHBOR = -121


def _topo(comm):
    topo = getattr(comm, "topo", None)
    if topo is None:
        raise ValueError("neighbor collective on a communicator "
                         "without a topology (MPI_ERR_TOPOLOGY)")
    return topo


def _reqs_allgather(comm, sarr, rarr, bcount: int, tag: int):
    """One irecv block per in-neighbor + one isend per out-neighbor."""
    topo = _topo(comm)
    srcs = topo.in_neighbors(comm.rank)
    dsts = topo.out_neighbors(comm.rank)
    pml = comm.state.pml
    dt_r = _dt(rarr)
    dt_s = _dt(sarr)
    reqs = [pml.irecv(rarr[i * bcount:(i + 1) * bcount], bcount, dt_r,
                      src, tag, comm)
            for i, src in enumerate(srcs)]
    reqs += [pml.isend(sarr, sarr.size, dt_s, dst, tag, comm)
             for dst in dsts]
    return reqs


def _reqs_alltoall(comm, sarr, sbcount: int, rarr, rbcount: int, tag: int):
    topo = _topo(comm)
    srcs = topo.in_neighbors(comm.rank)
    dsts = topo.out_neighbors(comm.rank)
    pml = comm.state.pml
    dt_r = _dt(rarr)
    dt_s = _dt(sarr)
    reqs = [pml.irecv(rarr[i * rbcount:(i + 1) * rbcount], rbcount, dt_r,
                      src, tag, comm)
            for i, src in enumerate(srcs)]
    reqs += [pml.isend(np.ascontiguousarray(
                 sarr[j * sbcount:(j + 1) * sbcount]), sbcount, dt_s,
                 dst, tag, comm)
             for j, dst in enumerate(dsts)]
    return reqs


def _reqs_alltoallv(comm, sarr, scounts, sdispls, rarr, rcounts, rdispls,
                    tag: int):
    topo = _topo(comm)
    srcs = topo.in_neighbors(comm.rank)
    dsts = topo.out_neighbors(comm.rank)
    pml = comm.state.pml
    dt_r = _dt(rarr)
    dt_s = _dt(sarr)
    reqs = [pml.irecv(rarr[rdispls[i]:rdispls[i] + rcounts[i]], rcounts[i],
                      dt_r, src, tag, comm)
            for i, src in enumerate(srcs)]
    reqs += [pml.isend(np.ascontiguousarray(
                 sarr[sdispls[j]:sdispls[j] + scounts[j]]), scounts[j],
                 dt_s, dst, tag, comm)
             for j, dst in enumerate(dsts)]
    return reqs


def _dt(arr: np.ndarray):
    return mpi_dtype_of(arr)


def _waitall(reqs) -> None:
    for r in reqs:
        r.wait()


# -- blocking entry points (buffer-spec altitude) ---------------------------
# Counts/displs arrive in datatype-element units; the flat arrays from
# typed() are primitive units, so scale by dt.size // prim.itemsize
# (same adaptation as coll/nbc's v-variants) before slicing.

def _scale(tb, dt) -> int:
    return dt.size // tb.prim.itemsize


def neighbor_allgather(comm, sbuf, scount, sdt, rbuf, rcount, rdt) -> None:
    """rbuf holds one scount-block per in-neighbor, in neighbor order."""
    sb = typed(sbuf, scount, sdt)
    nin = len(_topo(comm).in_neighbors(comm.rank))
    rb = typed(rbuf, rcount * nin, rdt, writable=True)
    _waitall(_reqs_allgather(comm, sb.arr, rb.arr,
                             rcount * _scale(rb, rdt), T_NEIGHBOR))
    rb.flush()


def neighbor_allgatherv(comm, sbuf, scount, sdt, rbuf, rcounts, displs,
                        rdt) -> None:
    sb = typed(sbuf, scount, sdt)
    total = max(d + c for d, c in zip(displs, rcounts)) if rcounts else 0
    rb = typed(rbuf, total, rdt, writable=True)
    rs = _scale(rb, rdt)
    topo = _topo(comm)
    pml = comm.state.pml
    reqs = [pml.irecv(rb.arr[displs[i] * rs:(displs[i] + rcounts[i]) * rs],
                      rcounts[i] * rs, _dt(rb.arr), src, T_NEIGHBOR, comm)
            for i, src in enumerate(topo.in_neighbors(comm.rank))]
    reqs += [pml.isend(sb.arr, sb.arr.size, _dt(sb.arr), dst, T_NEIGHBOR,
                       comm)
             for dst in topo.out_neighbors(comm.rank)]
    _waitall(reqs)
    rb.flush()


def neighbor_alltoall(comm, sbuf, sbcount, sdt, rbuf, rbcount, rdt) -> None:
    topo = _topo(comm)
    nin = len(topo.in_neighbors(comm.rank))
    nout = len(topo.out_neighbors(comm.rank))
    sb = typed(sbuf, sbcount * nout, sdt)
    rb = typed(rbuf, rbcount * nin, rdt, writable=True)
    _waitall(_reqs_alltoall(comm, sb.arr, sbcount * _scale(sb, sdt),
                            rb.arr, rbcount * _scale(rb, rdt), T_NEIGHBOR))
    rb.flush()


def neighbor_alltoallv(comm, sbuf, scounts, sdispls, sdt, rbuf, rcounts,
                       rdispls, rdt) -> None:
    stotal = max((d + c for d, c in zip(sdispls, scounts)), default=0)
    rtotal = max((d + c for d, c in zip(rdispls, rcounts)), default=0)
    sb = typed(sbuf, stotal, sdt)
    rb = typed(rbuf, rtotal, rdt, writable=True)
    ss, rs = _scale(sb, sdt), _scale(rb, rdt)
    _waitall(_reqs_alltoallv(
        comm, sb.arr, [c * ss for c in scounts],
        [d * ss for d in sdispls], rb.arr, [c * rs for c in rcounts],
        [d * rs for d in rdispls], T_NEIGHBOR))
    rb.flush()


# -- device-resident halo exchange (array altitude) -------------------------

def neighbor_allgather_arr(comm, x):
    """Device-tier MPI-3 neighbor allgather for cartesian comms.

    Returns a tensor stacked along a leading axis of length 2*ndims in
    MPI neighbor order (per dim: the coord-1 source, then the coord+1
    source).  PROC_NULL neighbors (non-periodic edges) yield a zero
    block — the array-altitude analog of the untouched recv block.

    The reference (ompi_tpu/topo/neighbor.py:160-186) holds one
    whole-comm ppermute per (dim, direction) and stacks the results;
    here it is one collective, ``coll.neighbor_allgather_arr``, whose
    device tiers meet once and write each member's stacked output in
    one launch (K2 peer) straight from its neighbours' deposits.  The
    results match; the routes differ."""
    from ompi_tpu_torch.topo.topo import CART
    topo = _topo(comm)
    if topo.kind != CART:
        raise ValueError("neighbor_allgather_arr needs a cartesian "
                         "topology (MPI_ERR_TOPOLOGY)")
    return comm.coll.neighbor_allgather_arr(comm, x, source_table(comm))


def source_table(comm) -> List[List[int]]:
    """Every member's in-neighbours in MPI neighbour order (PROC_NULL
    where a non-periodic edge has none), cached on the comm: the
    topology is immutable."""
    table = comm.__dict__.get("_nbr_sources")
    if table is None:
        topo = _topo(comm)
        table = comm.__dict__["_nbr_sources"] = [
            list(topo.in_neighbors(m)) for m in range(comm.size)]
    return table


# -- nonblocking (single-round nbc schedules) -------------------------------

def _ineighbor(comm, reqs_fn, *finish):
    """Wrap a one-round request set as an NBCRequest so it progresses
    with the other nonblocking collectives (ref: coll/libnbc).  The
    requests are posted eagerly — with a single round there is
    nothing to defer — and the schedule just tracks completion."""
    from ompi_tpu_torch.coll.nbc import NBCRequest, _nbc_tag

    reqs = reqs_fn(_nbc_tag(comm))
    rounds = [[(lambda r=r: r) for r in reqs]]

    def done():
        for tb in finish:
            if tb is not None:
                tb.flush()
    return NBCRequest(comm, rounds, done)


def ineighbor_allgather(comm, sbuf, scount, sdt, rbuf, rcount, rdt):
    sb = typed(sbuf, scount, sdt)
    nin = len(_topo(comm).in_neighbors(comm.rank))
    rb = typed(rbuf, rcount * nin, rdt, writable=True)
    pc = rcount * _scale(rb, rdt)
    return _ineighbor(
        comm,
        lambda tag: _reqs_allgather(comm, sb.arr, rb.arr, pc, tag), rb)


def ineighbor_alltoall(comm, sbuf, sbcount, sdt, rbuf, rbcount, rdt):
    topo = _topo(comm)
    nin = len(topo.in_neighbors(comm.rank))
    nout = len(topo.out_neighbors(comm.rank))
    sb = typed(sbuf, sbcount * nout, sdt)
    rb = typed(rbuf, rbcount * nin, rdt, writable=True)
    sc, rc = sbcount * _scale(sb, sdt), rbcount * _scale(rb, rdt)
    return _ineighbor(
        comm,
        lambda tag: _reqs_alltoall(comm, sb.arr, sc, rb.arr, rc, tag), rb)


def ineighbor_allgatherv(comm, sbuf, scount, sdt, rbuf, rcounts, displs,
                         rdt):
    sb = typed(sbuf, scount, sdt)
    total = max((d + c for d, c in zip(displs, rcounts)), default=0)
    rb = typed(rbuf, total, rdt, writable=True)
    rs = _scale(rb, rdt)

    def reqs_fn(tag):
        topo = _topo(comm)
        pml = comm.state.pml
        reqs = [pml.irecv(
            rb.arr[displs[i] * rs:(displs[i] + rcounts[i]) * rs],
            rcounts[i] * rs, _dt(rb.arr), src, tag, comm)
            for i, src in enumerate(topo.in_neighbors(comm.rank))]
        reqs += [pml.isend(sb.arr, sb.arr.size, _dt(sb.arr), dst, tag,
                           comm)
                 for dst in topo.out_neighbors(comm.rank)]
        return reqs

    return _ineighbor(comm, reqs_fn, rb)


def ineighbor_alltoallv(comm, sbuf, scounts, sdispls, sdt, rbuf, rcounts,
                        rdispls, rdt):
    stotal = max((d + c for d, c in zip(sdispls, scounts)), default=0)
    rtotal = max((d + c for d, c in zip(rdispls, rcounts)), default=0)
    sb = typed(sbuf, stotal, sdt)
    rb = typed(rbuf, rtotal, rdt, writable=True)
    ss, rs = _scale(sb, sdt), _scale(rb, rdt)
    pscounts = [c * ss for c in scounts]
    psdispls = [d * ss for d in sdispls]
    prcounts = [c * rs for c in rcounts]
    prdispls = [d * rs for d in rdispls]
    return _ineighbor(
        comm,
        lambda tag: _reqs_alltoallv(comm, sb.arr, pscounts, psdispls,
                                    rb.arr, prcounts, prdispls, tag), rb)
