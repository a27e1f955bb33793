"""fcoll/two_phase: collective read/write aggregation.

Port of the reference's io/fcoll.py, a re-design of ompio's two-phase
component (ref: ompi/mca/fcoll/
two_phase/fcoll_two_phase_file_write_all.c:41,58-70 — ROMIO's
exchange-and-write: the aggregate byte range touched by all ranks is
partitioned among aggregator ranks; each compute rank ships the
pieces of its request that fall in an aggregator's partition; the
aggregator does one contiguous read-modify-write per partition
instead of every rank issuing scattered syscalls).

The number of aggregators comes from the ``io_fcoll_num_aggregators``
MCA variable (0 = one per rank, the ufs default for single-host).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from ompi_tpu_torch.coll.buffers import typed
from ompi_tpu_torch.mca.params import registry
from ompi_tpu_torch.pml.request import Status

num_agg_var = registry.register(
    "io", "fcoll", "num_aggregators", 0, int,
    help="Aggregator count for two-phase collective IO "
         "(0 = every rank aggregates)")

T_META = -141
T_DATA = -142
T_BACK = -143


def _plan(file, offset: int, nbytes: int):
    """Per-rank segment list + the global partition among aggregators.
    Collective: every rank learns the aggregate [lo, hi) range."""
    comm = file.comm
    segs = file.view.map_bytes(offset, nbytes)
    # interleaved views (extent < true_ub) can emit out-of-order
    # offsets across tiles, so the hull needs min/max, not ends
    lo = min(o for o, _ in segs) if segs else np.iinfo(np.int64).max
    hi = max(o + ln for o, ln in segs) if segs else 0
    from ompi_tpu_torch.op import op as opmod
    mine = np.array([lo, -hi], dtype=np.int64)
    mn = np.empty(2, dtype=np.int64)
    comm.Allreduce(mine, mn, opmod.MIN)
    glo, ghi = int(mn[0]), int(-mn[1])
    if ghi <= glo:
        return segs, glo, ghi, 0, [], 0
    nagg = registry.lookup("io", "fcoll", "num_aggregators", 0) or comm.size
    span = ghi - glo
    # never create an empty partition: an aggregator that owns no
    # bytes would skip its receive loop and strand the metadata sends
    nagg = max(1, min(nagg, comm.size, span))
    base, rem = divmod(span, nagg)
    bounds = [glo + a * base + min(a, rem) for a in range(nagg + 1)]
    parts = [(bounds[a], bounds[a + 1]) for a in range(nagg)]
    return segs, glo, ghi, nagg, parts, bounds


def _chunk_fn(bounds):
    from bisect import bisect_right

    def chunk_of(pos: int) -> int:
        return min(bisect_right(bounds, pos) - 1, len(bounds) - 2)
    return chunk_of


def _split_for_aggregators(segs, parts, nagg: int, chunk_of):
    """Slice this rank's (off, len) segments by aggregator partition;
    returns per-aggregator (offsets[], lens[], data-ranges[])."""
    per: List[List[Tuple[int, int, int]]] = [[] for _ in range(nagg)]
    dpos = 0
    for off, ln in segs:
        left = ln
        cur = off
        while left > 0:
            a = chunk_of(cur)
            pend = parts[a][1]
            take = min(left, pend - cur)
            per[a].append((cur, take, dpos))
            dpos += take
            cur += take
            left -= take
    return per


def _pack_meta(items) -> np.ndarray:
    """[n, off0, ln0, off1, ln1, ...] int64 wire vector."""
    meta = np.zeros(1 + 2 * len(items), dtype=np.int64)
    meta[0] = len(items)
    for i, (off, ln, _dpos) in enumerate(items):
        meta[1 + 2 * i] = off
        meta[2 + 2 * i] = ln
    return meta


def _iter_meta(meta: np.ndarray):
    """Yield (off, ln) pairs from a packed meta vector."""
    for i in range(int(meta[0])):
        yield int(meta[1 + 2 * i]), int(meta[2 + 2 * i])


def _recv_meta(pml, src: int, comm) -> np.ndarray:
    """Meta vectors are variable length: probe for the size first."""
    from ompi_tpu_torch.datatype import engine as dtmod
    st = pml.probe(src, T_META, comm)
    n = st.count // 8
    meta = np.empty(n, dtype=np.int64)
    pml.recv(meta, n, dtmod.INT64_T, src, T_META, comm)
    return meta


def _merge_intervals(ivs):
    ivs.sort()
    out = []
    for lo, hi in ivs:
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def _interval_lookup(merged):
    """merged disjoint (lo, hi) intervals → fn(off) = (index, off-lo).
    Callers guarantee every queried (off, len) lies wholly inside one
    interval (pieces/requests were merged from the same inputs)."""
    from bisect import bisect_right
    starts = [lo for lo, _ in merged]

    def locate(off: int):
        i = bisect_right(starts, off) - 1
        return i, off - starts[i]
    return locate


def write_all(file, offset: int, spec) -> Status:
    comm = file.comm
    buf, count, dt = file._spec(spec)
    tb = typed(buf, count, dt)
    raw = np.ascontiguousarray(tb.arr).view(np.uint8)
    segs, glo, ghi, nagg, parts, bounds = _plan(file, offset, raw.nbytes)
    if nagg == 0:  # nobody writes anything
        return Status()
    chunk_of = _chunk_fn(bounds)

    per = _split_for_aggregators(segs, parts, nagg, chunk_of)
    pml = comm.state.pml
    from ompi_tpu_torch.datatype import engine as dtmod

    # ship metadata + data to each aggregator (including self, via pml)
    reqs = []
    for a in range(nagg):
        items = per[a]
        payload = bytearray()
        for off, ln, dpos in items:
            payload += raw[dpos:dpos + ln].tobytes()
        meta = _pack_meta(items)
        reqs.append(pml.isend(meta, meta.size, dtmod.INT64_T, a, T_META,
                              comm))
        data = np.frombuffer(bytes(payload), dtype=np.uint8)
        reqs.append(pml.isend(data, data.size, dtmod.BYTE, a, T_DATA,
                              comm))

    # aggregator role: collect every rank's pieces, then allocate one
    # buffer per *covered* interval (never the whole partition span —
    # sparse writes at far-apart offsets must not allocate span/nagg
    # bytes) and write only those intervals.  Holes are never touched,
    # so no read-modify-write (and no pread on WRONLY files).
    if comm.rank < nagg:
        pieces: List[Tuple[int, np.ndarray]] = []  # (abs_off, bytes)
        covered = []
        for src in range(comm.size):
            meta = _recv_meta(pml, src, comm)
            total = sum(ln for _, ln in _iter_meta(meta))
            data = np.empty(total, dtype=np.uint8)
            pml.recv(data, total, dtmod.BYTE, src, T_DATA, comm)
            o = 0
            for off, ln in _iter_meta(meta):
                pieces.append((off, data[o:o + ln]))
                covered.append((off, off + ln))
                o += ln
        merged = _merge_intervals(covered)
        if merged:
            locate = _interval_lookup(merged)
            regions = [bytearray(hi - lo) for lo, hi in merged]
            for off, piece in pieces:  # later sources win, as received
                i, o = locate(off)
                regions[i][o:o + len(piece)] = piece.data
            for (lo, hi), region in zip(merged, regions):
                file._pwrite_segs([(lo, hi - lo)], memoryview(region))
    for r in reqs:
        r.wait()
    comm.Barrier()  # write_all is collective: data visible on return
    st = Status()
    st.count = raw.nbytes
    return st


def read_all(file, offset: int, spec) -> Status:
    comm = file.comm
    buf, count, dt = file._spec(spec)
    tb = typed(buf, count, dt, writable=True)
    nbytes = tb.arr.nbytes
    segs, glo, ghi, nagg, parts, bounds = _plan(file, offset, nbytes)
    if nagg == 0:
        return Status()
    chunk_of = _chunk_fn(bounds)

    per = _split_for_aggregators(segs, parts, nagg, chunk_of)
    pml = comm.state.pml
    from ompi_tpu_torch.datatype import engine as dtmod

    # request phase: send each aggregator the wanted (off, len) list
    reqs = []
    for a in range(nagg):
        meta = _pack_meta(per[a])
        reqs.append(pml.isend(meta, meta.size, dtmod.INT64_T, a, T_META,
                              comm))

    # serve phase: aggregator collects every request list first, preads
    # only the union of requested intervals (never the whole partition
    # — sparse reads must not allocate or read span/nagg bytes), and
    # answers each rank from memory.  Per-interval actual read counts
    # from _pread_segs_counted give true EOF byte counts, which travel
    # back with the data so Status.count matches the individual path.
    if comm.rank < nagg:
        metas = [_recv_meta(pml, src, comm) for src in range(comm.size)]
        wanted = _merge_intervals(
            [(off, off + ln) for m in metas for off, ln in _iter_meta(m)])
        locate = _interval_lookup(wanted)
        regions: List[bytes] = []
        avail: List[int] = []          # readable end of each interval
        for lo, hi in wanted:
            data_i, actual = file._pread_segs_counted([(lo, hi - lo)])
            regions.append(data_i)
            avail.append(lo + actual)
        for src, meta in enumerate(metas):
            # response = 8-byte true-count header + the padded data,
            # one message (the count must not double T_BACK traffic)
            resp = bytearray(8)
            got = 0
            for off, ln in _iter_meta(meta):
                i, o = locate(off)
                resp += regions[i][o:o + ln]
                got += max(0, min(off + ln, avail[i]) - off)
            resp[:8] = np.int64(got).tobytes()
            arr = np.frombuffer(bytes(resp), dtype=np.uint8)
            reqs.append(pml.isend(arr, arr.size, dtmod.BYTE, src, T_BACK,
                                  comm))

    # gather phase: collect the slices back, in aggregator order
    out = np.empty(nbytes, dtype=np.uint8)
    true_count = 0
    for a in range(nagg):
        items = per[a]
        total = sum(ln for _, ln, _ in items)
        data = np.empty(total + 8, dtype=np.uint8)
        pml.recv(data, total + 8, dtmod.BYTE, a, T_BACK, comm)
        true_count += int(data[:8].view(np.int64)[0])
        data = data[8:]
        o = 0
        for off, ln, dpos in items:
            out[dpos:dpos + ln] = data[o:o + ln]
            o += ln
    tb.arr.view(np.uint8)[:] = out
    tb.flush()
    for r in reqs:
        r.wait()
    comm.Barrier()
    st = Status()
    st.count = true_count
    return st
