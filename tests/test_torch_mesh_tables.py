"""K6 mesh_fold and K2 peer copy over destination tables
(ompi_tpu_torch/kernels/mesh.py, stacked.py): the mesh tier's one
launch a card.

On the CPU the wrappers take their plain versions, so these tests hold
(1) the table forms, ``mesh_fold_many`` / ``peer_copy_many`` and their
plain versions, against one plain call a destination, byte for byte,
and against the reference's own segment programs
(``coll/pipeline._build_seg_kernel``, jax on virtual CPU devices) for
a table of every member's stripe; and (2) the Python planners the
kernels are launched from: the grouping of destinations into one
launch a card (``groups``), the split of a table over MAX_JOBS, and the
tiling — K6's head, bulk and edge tiles of a job (``_fold_job``,
``_fold_job_tiles``, ``_fold_span``) and K2's row tiles and split
(``_row_tiles``, ``_row_split``) — which must cover every element of
every destination exactly once, its bulk spans whole 16-byte vectors
at 16-byte-aligned addresses on both sides.  Pointers there are
integers, drawn over many cases from a seeded generator.

Tolerance: exact throughout (the same fold in the same order, or the
same bytes moved).  The kernels themselves are held against the plain
versions on the card by the gpu-marked test at the end (skipped
without a card).
"""

import zlib

import numpy as np
import pytest
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch.kernels import mesh, stacked

DTYPES = [torch.float16, torch.bfloat16, torch.float32, torch.float64,
          torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
          torch.uint32, torch.int64, torch.uint64, torch.bool,
          torch.complex64, torch.complex128]
OPS = list(stacked._OPS)


def _values(rng, n, dtype, op):
    """n values of ``dtype`` made with numpy: small integers for PROD
    and the logical ops, full-width bit patterns otherwise."""
    if dtype == torch.bool:
        return torch.from_numpy(rng.integers(0, 2, n).astype(np.bool_))
    if dtype.is_complex:
        z = rng.standard_normal(n) + 1j * rng.standard_normal(n)
        z = 1.0 + 0.1 * z if op == "MPI_PROD" else z
        return torch.from_numpy(z).to(dtype)
    if dtype.is_floating_point:
        a = rng.standard_normal(n)
        return torch.from_numpy(1.0 + 0.1 * a if op == "MPI_PROD"
                                else a).to(dtype)
    if op in ("MPI_PROD", "MPI_LAND", "MPI_LOR", "MPI_LXOR"):
        return torch.from_numpy(rng.integers(0, 4, n)).to(dtype)
    bits = torch.from_numpy(rng.integers(-2 ** 63, 2 ** 63 - 1, n,
                                         dtype=np.int64, endpoint=True))
    return bits.view(torch.uint8)[:n * dtype.itemsize].view(dtype).clone()


def _same(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


def _orders(n, seg):
    return ["rank", ("ring", seg, seg // n)] + \
        (["tree"] if n & (n - 1) == 0 else [])


# ---------------------------------------------------------------------------
# the table forms against one plain call a destination
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
def test_mesh_fold_many_equals_one_plain_call_a_destination(dtype):
    """mesh_fold_many (the wrapper, on CPU tensors) and
    mesh_fold_many_plain equal mesh_fold_plain job by job, byte for
    byte: every op K1 takes on this dtype, N in {2, 3, 8}, every order
    (rank, segring, and segrd's tree for N a power of two), ragged job
    lengths (1, 17, 129, 1000) at scattered offsets, and for the first
    op a table of 70 jobs (two kernel tables on a card)."""
    rng = np.random.default_rng(zlib.crc32(str(dtype).encode()))
    ops = [op for op in OPS if stacked.reduce_supported(dtype, op)]
    for op in ops:
        for n in (2, 3, 8):
            seg = 16 * n
            total = 1200
            xs = [_values(rng, total, dtype, op) for _ in range(n)]
            for order in _orders(n, seg):
                for k in (1, 4) + ((70,) if op == ops[0] else ()):
                    lens = [(1, 17, 129, 1000)[q % 4] for q in range(k)]
                    jobs = [(torch.empty(ln, dtype=dtype),
                             int(rng.integers(0, total - ln + 1)))
                            for ln in lens]
                    got = mesh.mesh_fold_many(xs, jobs, op, order)
                    twin = [(torch.empty_like(o), lo) for o, lo in jobs]
                    plain = mesh.mesh_fold_many_plain(xs, twin, op, order)
                    for (o, lo), g, p in zip(jobs, got, plain):
                        want = mesh.mesh_fold_plain(xs, lo, o.numel(), op,
                                                    order)
                        assert g is o
                        assert _same(g, want) and _same(p, want), \
                            (op, n, order, k, lo)


PEER_CASES = [
    ("gather", {"block": 37}),
    ("gather clipped", {"block": 37, "limit": 3 * 37 + 5}),
    ("alltoall", {"block": 11, "src_stride": 11}),
    ("column segment", {"block": 3, "src_stride": 11, "src_off": 2,
                        "out_stride": 11, "out_off": 4}),
]


@pytest.mark.parametrize("name,kw", PEER_CASES, ids=[c[0] for c in PEER_CASES])
@pytest.mark.parametrize("nulls", [False, True], ids=["sources", "nulls"])
def test_peer_copy_many_equals_one_plain_call_a_destination(name, kw, nulls):
    """peer_copy_many (the wrapper, on CPU tensors) and
    peer_copy_many_plain equal peer_copy_plain destination by
    destination (destination i takes block first_dst + i), with and
    without PROC_NULL sources at either end (zeros in their blocks),
    for 1, 4 and 130 destinations (two kernel tables on a card)."""
    rng = np.random.default_rng(zlib.crc32(f"{name}{nulls}".encode()))
    n = 4
    xs = [torch.from_numpy(rng.integers(-99, 99, 60).astype(np.int32))
          for _ in range(n)]
    srcs = [None] + xs[1:-1] + [None] if nulls else xs
    span = n * max(kw["block"], kw.get("out_stride", 0)) + 8
    for nd in (1, 4, 130):
        first = 0 if "src_stride" not in kw else 1
        nd = min(nd, 4) if "src_stride" in kw else nd
        outs = [torch.full((span,), -5, dtype=torch.int32)
                for _ in range(nd)]
        twin = [o.clone() for o in outs]
        want = [o.clone() for o in outs]
        got = stacked.peer_copy_many(srcs, outs, first_dst=first, **kw)
        stacked.peer_copy_many_plain(srcs, twin, first_dst=first, **kw)
        for i, w in enumerate(want):
            stacked.peer_copy_plain(srcs, w, dst=first + i, **kw)
        for g, o, t, w in zip(got, outs, twin, want):
            assert g is o and torch.equal(g, w) and torch.equal(t, w)
        if nulls:
            b = kw["block"]
            assert not outs[0][kw.get("out_off", 0):][:b].any()


# ---------------------------------------------------------------------------
# the table forms against the reference's segment programs
# ---------------------------------------------------------------------------

REF_PAIRS = [(np.dtype(np.float32), "MPI_SUM"),
             (np.dtype(np.float32), "MPI_PROD"),
             (np.dtype(np.float32), "MPI_MAX"),
             (np.dtype(np.int32), "MPI_SUM"),
             (np.dtype(np.int32), "MPI_BXOR"),
             (np.dtype(np.int32), "MPI_LAND"),
             (np.dtype(np.uint8), "MPI_MAX")]


@pytest.mark.parametrize("dt,op", REF_PAIRS,
                         ids=[f"{d.name}-{o[4:]}" for d, o in REF_PAIRS])
@pytest.mark.parametrize("kind", ["segring", "segrd"])
def test_table_of_stripes_matches_reference_schedule(kind, dt, op):
    """A destination table of every member's stripe — what one K6
    launch a card folds for a mesh allreduce — concatenated, against
    the reference's segment program (segring or segrd) on the same
    numpy shards: byte for byte, float SUM and PROD included."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from ompi_tpu.coll.pipeline import _build_seg_kernel
    n, seg = 4, 4 * 29
    rng = np.random.default_rng(zlib.crc32(f"{kind}{dt.name}{op}".encode()))
    if dt.kind == "f":
        a = 1.0 + 0.1 * rng.standard_normal((n, seg)) if op == "MPI_PROD" \
            else rng.standard_normal((n, seg))
    else:
        a = rng.integers(0, 4 if op == "MPI_LAND" else 100, (n, seg))
    shards = [s.astype(dt) for s in a]
    dmesh = Mesh(np.array(jax.devices()[:n]), ("r",))
    g = jax.device_put(np.concatenate(shards),
                       NamedSharding(dmesh, P("r")))
    want = np.asarray(_build_seg_kernel(kind, dmesh, seg, dt, op)(g))[:seg]
    xs = [convert.to_torch(s, torch.device("cpu")) for s in shards]
    m = seg // n
    order = ("ring", seg, m) if kind == "segring" else "tree"
    outs = mesh.mesh_fold_many(xs, [(torch.empty(m, dtype=xs[0].dtype),
                                     d * m) for d in range(n)], op, order)
    got = convert.to_numpy(torch.cat(outs))
    assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# the planners: one launch a card, splits, tiles
# ---------------------------------------------------------------------------

ISZ = [1, 2, 4, 8, 16]
CARDS = [torch.device("cuda", i) for i in range(4)]


def _fold_case(rng, n, njobs, cards):
    """Random K6 inputs (addresses), jobs (card, out address, lo, len)
    and geometry: aligned or element-offset pointers, ragged lengths."""
    isz = int(rng.choice(ISZ))
    total = int(rng.integers(1, 6000))
    shift = int(rng.integers(0, 16 // isz)) * isz if rng.random() < 0.5 \
        else 0
    ptrs = [(1 << 20) * (i + 1) + shift + (isz * int(rng.integers(0, 3))
                                           if rng.random() < 0.2 else 0)
            for i in range(n)]
    jobs = []
    for _ in range(njobs):
        ln = int(rng.integers(1, total + 1))
        lo = int(rng.integers(0, total - ln + 1))
        out = (1 << 30) + isz * int(rng.integers(0, 4096))
        jobs.append((cards[int(rng.integers(0, len(cards)))], out, lo, ln))
    seg = m = 0
    tree = 0
    r = rng.random()
    if r < 0.3:
        m = int(rng.integers(1, 64))
        seg = m * n
    elif r < 0.5 and n & (n - 1) == 0:
        tree = 1
    return isz, ptrs, jobs, tree, seg, m


@pytest.mark.parametrize("seed", range(8))
def test_fold_tables_one_launch_a_card_and_split(seed):
    """K6's planner: jobs on one card make one table; on distinct cards
    one table each, in order of first appearance; a card's jobs beyond
    MAX_JOBS split into further tables; every job lands in exactly one
    table, once."""
    rng = np.random.default_rng(seed)
    for _ in range(50):
        n = int(rng.integers(1, 9))
        ncards = int(rng.integers(1, 5))
        njobs = int(rng.integers(1, 150))
        isz, ptrs, jobs, tree, seg, m = _fold_case(rng, n, njobs,
                                                   CARDS[:ncards])
        tables = mesh._fold_tables(ptrs, jobs, isz, tree, seg, m)
        per_card = {}
        for card, *_ in jobs:
            per_card[card] = per_card.get(card, 0) + 1
        want = sum(-(-k // mesh.MAX_JOBS) for k in per_card.values())
        assert len(tables) == want
        seen = []
        for card, a in tables:
            assert 1 <= a.njobs <= mesh.MAX_JOBS
            for q in range(a.njobs):
                rec = a.job[q]
                match = [i for i, j in enumerate(jobs)
                         if j[0] == card and (j[1], j[2], j[3]) ==
                         (rec.out, rec.lo, rec.len) and i not in seen]
                assert match
                seen.append(match[0])
        assert sorted(seen) == list(range(njobs))
        assert [c for c, _ in tables][0] == jobs[0][0]


@pytest.mark.parametrize("seed", range(8))
def test_fold_tiles_cover_every_element_once(seed):
    """K6's tiling of each job (_fold_job, _fold_job_tiles, _fold_span,
    the Python statement of mesh.cu's fold_span): the tiles of a job
    cover [0, len) exactly once; a bulk tile is whole vectors, at most
    one tile long, 16-byte aligned in every input and in the output;
    a job is bulk only when its inputs and output are congruent modulo
    16 (and, segring, no vector straddles a stripe); the prefix table
    counts each job's tiles; a head, when there is one, brings every
    pointer to a 16-byte boundary."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(40):
        n = int(rng.integers(1, 9))
        isz, ptrs, jobs, tree, seg, m = _fold_case(
            rng, n, int(rng.integers(1, 70)), CARDS[:1])
        v = 16 // isz
        tile = mesh._fold_tile(n, isz)
        assert tile * isz % 16 == 0 and tile >= v
        for _, a in mesh._fold_tables(ptrs, jobs, isz, tree, seg, m):
            for q in range(a.njobs):
                rec = a.job[q]
                end = a.job[q + 1].first_tile if q + 1 < a.njobs \
                    else a.ntiles
                ntiles = end - rec.first_tile
                assert ntiles == mesh._fold_job_tiles(rec.len, rec.head,
                                                      tile, v)
                r = rec.out % 16
                congruent = all((p + rec.lo * isz) % 16 == r for p in ptrs)
                if rec.head >= 0:
                    assert congruent
                    assert (rec.out + rec.head * isz) % 16 == 0 or \
                        rec.head == rec.len
                elif congruent and not m:
                    raise AssertionError("congruent job on the edge path")
                hit = np.zeros(rec.len, np.int64)
                for k in range(ntiles):
                    kind, e0, e1 = mesh._fold_span(rec.len, rec.head, tile,
                                                   v, k)
                    if kind == 2:
                        hit[:e0] += 1
                        hit[e1:] += 1
                        continue
                    assert 0 < e1 - e0 <= tile
                    hit[e0:e1] += 1
                    if kind == 1:
                        assert (e1 - e0) % v == 0
                        assert (rec.out + e0 * isz) % 16 == 0
                        assert all((p + (rec.lo + e0) * isz) % 16 == 0
                                   for p in ptrs)
                        if m:
                            g0 = rec.lo + e0
                            assert g0 % v == 0 and m % v == 0 and \
                                seg % v == 0
                assert (hit == 1).all()


@pytest.mark.parametrize("seed", range(8))
def test_copy_tables_one_launch_a_card_and_split(seed):
    """K2 peer's planner: destinations on one card make one table; on
    distinct cards one table each; beyond MAX_PTRS a card's
    destinations split; every destination keeps its source block index
    (first_dst + its position); nothing to move makes no table."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(50):
        nsrc = int(rng.integers(1, 9))
        ncards = int(rng.integers(1, 5))
        nd = int(rng.integers(1, 300))
        outs = [(CARDS[int(rng.integers(0, ncards))], (1 << 30) + 64 * i)
                for i in range(nd)]
        first = int(rng.integers(0, 4))
        chunk = int(rng.integers(0, 5000))
        tables = stacked._copy_tables([4096 * (j + 1) for j in range(nsrc)],
                                      outs, first, chunk, chunk, chunk,
                                      nsrc * chunk)
        if chunk == 0:
            assert tables == []
            continue
        per_card = {}
        for card, _ in outs:
            per_card[card] = per_card.get(card, 0) + 1
        assert len(tables) == sum(-(-k // stacked.MAX_PTRS)
                                  for k in per_card.values())
        seen = []
        for card, c in tables:
            assert c.ntiles == c.nout * c.first_tile[c.n]
            for il in range(c.nout):
                i = c.dst[il] - first
                assert outs[i] == (card, c.out[il]) and i not in seen
                seen.append(i)
        assert sorted(seen) == list(range(nd))


@pytest.mark.parametrize("seed", range(8))
def test_copy_tiles_cover_every_byte_once(seed):
    """K2's tiling (_row_tiles, _row_split, the Python statement of
    stacked.cu's copy_row / bulk_span): over every destination's rows,
    clipped by the limit, the tiles cover each row's bytes exactly
    once; a bulk span is whole 16-byte vectors, at most one tile,
    16-byte aligned at both source and destination; only a row whose
    source and destination are congruent modulo 16 has bulk spans,
    and its edges lie in its last tile; a null source's row is all
    edge (zeros)."""
    rng = np.random.default_rng(300 + seed)
    tile = stacked.COPY_TILE
    for _ in range(60):
        nsrc = int(rng.integers(1, 9))
        chunk = int(rng.integers(1, 3 * tile))
        out_stride = chunk + int(rng.integers(0, 40))
        limit = int(rng.integers(1, nsrc * out_stride + 1))
        pre = stacked._row_tiles(nsrc, chunk, out_stride, limit, tile)
        srcs = [None if rng.random() < 0.15 else
                (1 << 24) * (j + 1) + int(rng.integers(0, 64))
                for j in range(nsrc)]
        dst0 = (1 << 32) + int(rng.integers(0, 64))
        for j in range(nsrc):
            cnt = min(chunk, limit - j * out_stride)
            ntile = pre[j + 1] - pre[j]
            assert ntile == (-(-cnt // tile) if cnt > 0 else 0)
            if cnt <= 0:
                continue
            src, dst = srcs[j], dst0 + j * out_stride
            hit = np.zeros(cnt, np.int64)
            for k in range(ntile):
                bulk, edges = stacked._row_split(src, dst, cnt, k, tile)
                if bulk is not None:
                    b0, b1 = bulk
                    assert src is not None and (src ^ dst) & 15 == 0
                    assert (src + b0) % 16 == 0 and (dst + b0) % 16 == 0
                    assert (b1 - b0) % 16 == 0 and 0 < b1 - b0 <= tile
                    hit[b0:b1] += 1
                if edges and src is not None and (src ^ dst) & 15 == 0:
                    assert k == ntile - 1
                for e0, e1 in edges:
                    hit[e0:e1] += 1
            assert (hit == 1).all()


def test_groups_keep_first_appearance_order():
    """``groups``: indices by device in order of first appearance, runs
    of at most ``cap`` each."""
    d = CARDS
    assert stacked.groups([d[1], d[0], d[1], d[0], d[1]], 2) == \
        [[0, 2], [4], [1, 3]]
    assert stacked.groups([d[0]] * 5, 64) == [[0, 1, 2, 3, 4]]
    assert stacked.groups([], 3) == []


def test_wrappers_refuse_mixed_and_count_no_plain_launch():
    """A CPU destination takes CPU inputs, a table mixing a CPU and a
    card destination is refused (no fallback), and the plain versions
    taken for CPU tensors are not launches."""
    xs = [torch.ones(8) for _ in range(2)]
    before = (mesh.mesh_fold.launches.value, stacked.peer_copy.launches.value)
    mesh.mesh_fold_many(xs, [(torch.empty(4), 0), (torch.empty(4), 4)],
                        "MPI_SUM")
    stacked.peer_copy_many(xs, [torch.empty(16), torch.empty(16)], 8)
    assert (mesh.mesh_fold.launches.value,
            stacked.peer_copy.launches.value) == before
    meta = torch.empty(4, device="meta")
    with pytest.raises(ValueError):
        mesh.mesh_fold_many(xs, [(torch.empty(4), 0), (meta, 4)], "MPI_SUM")
    with pytest.raises(ValueError):
        stacked.peer_copy_many(
            xs, [torch.empty(16), torch.empty(16, device="meta")], 8)
    with pytest.raises(ValueError, match="outside"):
        mesh.mesh_fold_many(xs, [(torch.empty(4), 6)], "MPI_SUM")


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never while the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_grouped_kernels_match_plain_on_card(cuda_device):
    """K6 over tables of 1, 8 and 70 jobs (one launch, one, two) and K2
    peer over 1, 8 and 130 destinations (one, one, two), against their
    plain versions on the card: exact, and bit-identical across two
    launches; congruent and one-element-off outputs, PROC_NULL
    sources."""
    rng = np.random.default_rng(71)
    for dtype, op in ((torch.float32, "MPI_SUM"), (torch.float16, "MPI_MAX"),
                      (torch.int32, "MPI_BXOR"), (torch.bool, "MPI_LOR"),
                      (torch.complex128, "MPI_PROD")):
        for n in (3, 8):
            xs = [_values(rng, 9000, dtype, op).to(cuda_device)
                  for _ in range(n)]
            for order in _orders(n, 64 * n):
                for k in (1, 8, 70):
                    spec = [(int(rng.integers(0, 4000)),
                             (3000, 1, 17, 2048)[q % 4], q % 2)
                            for q in range(k)]
                    runs = []
                    for _ in range(2):
                        before = mesh.mesh_fold.launches.value
                        outs = [torch.empty(ln + s, dtype=dtype,
                                            device=cuda_device)[s:]
                                for _, ln, s in spec]
                        mesh.mesh_fold_many(
                            xs, list(zip(outs, [lo for lo, _, _ in spec])),
                            op, order)
                        assert mesh.mesh_fold.launches.value - before == \
                            -(-k // mesh.MAX_JOBS)
                        runs.append(outs)
                    for (lo, ln, _), a, b in zip(spec, *runs):
                        want = mesh.mesh_fold_plain(xs, lo, ln, op, order)
                        assert _same(a, want) and _same(a, b)
    for dtype in (torch.float32, torch.int8, torch.float64):
        xs = [_values(rng, 4 * 20000 + 1, dtype, "MPI_SUM").to(cuda_device)
              for _ in range(4)]
        for srcs in (xs, [None] + xs[1:3] + [None], [x[1:] for x in xs]):
            for nd in (1, 8, 130):
                for shift in (0, 1):
                    outs = [torch.full((4 * 20000 + 1,), 7, dtype=dtype,
                                       device=cuda_device)[shift:]
                            for _ in range(nd)]
                    want = [o.clone() for o in outs]
                    again = [o.clone() for o in outs]
                    before = stacked.peer_copy.launches.value
                    stacked.peer_copy_many(srcs, outs, 20000)
                    assert stacked.peer_copy.launches.value - before == \
                        -(-nd // stacked.MAX_PTRS)
                    stacked.peer_copy_many(srcs, again, 20000)
                    stacked.peer_copy_many_plain(srcs, want, 20000)
                    for a, b, w in zip(outs, again, want):
                        assert torch.equal(a, w) and torch.equal(a, b)
    torch.cuda.synchronize()
