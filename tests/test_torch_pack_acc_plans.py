"""The planners of K7 slot_pack and K9 rma_acc (ompi_tpu_torch/kernels/
mesh.py ``_pack_plan`` / ``_pack_tables``, rma.py ``_acc_split``).

Each kernel is launched from a plan worked out in Python from integer
addresses, so the plan is what the CPU can hold:

- K7 moves each slot at its own width: head bytes up to the slot's
  first 16-byte-aligned output address, a body of units of the widest
  width at which source and output are both aligned there (16 for a
  zero slot), tail bytes; the slot table (one launch a run of
  MAX_SLOTS slots that holds any byte) and its block prefix, which the
  kernel's ballot lookup walks;
- K9 splits an op on the target's alignment: head elements before w
  reaches 16 bytes, a body of 16-byte vectors, the tail, and each
  operand's own mode at the body's start.

Each plan is held to the alignment facts it must meet, at addresses of
every residue modulo 16, and executed here with torch slicing (head,
body at its width, tail), which must give the plain versions' bytes
(``slot_pack_plain``, ``rma_acc_plain``).  Tolerance:
exact.  The kernels themselves are held against the plain versions on
the card by the gpu-marked test at the end (skipped without a card).
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch.kernels import mesh, rma

WIDTHS = (16, 8, 4, 2, 1)
# a torch dtype of each unit width but 16, which moves as int64 pairs
_UNIT = {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}


def _aligned(addrs, w):
    return all(a % w == 0 for a in addrs)


@pytest.mark.parametrize("zero", [False, True], ids=["data", "zero"])
@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 49])
def test_pack_plan_alignment_facts(n, zero):
    """Every residue of source and packed offset modulo 16, slot sizes
    of 0, 1, 15, 16, 17 and 3 vectors + 1 bytes: head, body and tail
    make up the slot, the head ends at the output's first 16-byte
    boundary (or the slot), the tail is under one unit; every unit of
    the body is aligned at its width on both sides (16 for a zero slot,
    whose source is never read), and no wider width is."""
    out = 1 << 20
    for rs in range(16):
        for rd in range(16):
            src, d = 4096 + rs, out + rd
            (row,) = mesh._pack_plan([src], [n], out, [rd], [zero])
            head, w, units, tail = row
            assert w in WIDTHS and head + units * w + tail == n
            assert 0 <= tail < w, (rs, rd)
            if head < n:
                assert head < 16 and (d + head) % 16 == 0, (rs, rd)
            else:
                assert all((d + h) % 16 for h in range(n)), (rs, rd)
            sides = [d + head] + ([] if zero else [src + head])
            starts = [p + k * w for p in sides for k in range(units)]
            assert _aligned(starts, w), (rs, rd)
            assert w == 16 or not _aligned(sides, 2 * w), (rs, rd)


def test_pack_plan_narrows_only_the_odd_slot():
    """One slot whose source is 4 bytes off its packed place goes at
    4-byte units; every other slot's body stays at 16 (the launch-wide
    rule narrowed the whole batch to 4).  The ragged mix of 32 slots of
    64 KiB + 20 B skews each slot by its own offset: 16, 4, 8, 4, ... in
    turn, each slot at its own width."""
    nb = 65536
    srcs = [(1 << 24) + k * (1 << 20) for k in range(32)]
    srcs[7] += 4
    offs = [k * nb for k in range(32)]
    plan = mesh._pack_plan(srcs, [nb] * 32, 1 << 30, offs, [False] * 32)
    assert [w for _, w, _, _ in plan] == [4 if k == 7 else 16
                                          for k in range(32)]
    nb = 65536 + 20
    plan = mesh._pack_plan(srcs[:7] + srcs[8:] + [srcs[0]], [nb] * 32,
                           1 << 30, [k * nb for k in range(32)], [False] * 32)
    assert [w for _, w, _, _ in plan] == [(16, 4, 8, 4)[k % 4]
                                          for k in range(32)]
    for k, (head, w, units, tail) in enumerate(plan):
        assert head == -(k * 20) % 16 and head + units * w + tail == nb


@pytest.mark.parametrize("nslots", [1, 9, 64, 65, 129, 32])
@pytest.mark.parametrize("units", [256, 1024])
def test_pack_tables_split_and_cover_every_unit_once(nslots, units,
                                                     monkeypatch):
    """MAX_SLOTS slots a table (64 slots: one launch; 65: two); a run of
    empty slots launches nothing; the first_block prefix; and each
    block, found as the kernel finds it (the count of slots whose first
    block is at most its index, less one), covers a span of ``UNITS``
    16-byte units of its slot's body that, over the slot's blocks,
    covers every unit once — its first block also taking the head and
    the tail, the only block of a slot with no body; where every slot
    takes as many blocks (32 slots of 64 KiB + 20 B), ``each`` is that
    count and block b's slot b // each.  At the kernel's block span and
    at another (a sweep builds the kernel at others)."""
    monkeypatch.setattr(mesh, "UNITS", units)
    rng = np.random.default_rng(nslots * 7 + units)
    sizes = [int(rng.choice([0, 1, 15, 17, 49, 4096, 70001, 300000]))
             for _ in range(nslots)]
    if nslots == 65:
        sizes[-1] = 0  # the second run holds no byte: one launch
    srcs = [int(rng.integers(0, 1 << 20)) * 16 + int(rng.integers(0, 16))
            for _ in sizes]
    zero = [bool(rng.integers(0, 4) == 0) for _ in sizes]
    if nslots == 32:  # the ragged mix, one size: ``each`` blocks a slot
        sizes, zero = [65556] * nslots, [False] * nslots
        srcs = [(k + 1) << 20 for k in range(nslots)]
    out = 1 << 32
    tables = mesh._pack_tables(srcs, sizes, out, zero)
    runs = [range(lo, min(lo + mesh.MAX_SLOTS, nslots))
            for lo in range(0, nslots, mesh.MAX_SLOTS)]
    runs = [r for r in runs if any(sizes[i] for i in r)]
    assert len(tables) == len(runs) == (1 if nslots == 65 else
                                        -(-nslots // mesh.MAX_SLOTS))
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).tolist()
    plan = mesh._pack_plan(srcs, sizes, out, offs, zero)
    for (a, nblocks), run in zip(tables, runs):
        assert a.nslots == len(run) and a.out == out
        fb = list(a.first_block)[:a.nslots]
        assert fb[0] == 0 and fb == sorted(fb)
        cover = {j: [] for j in range(a.nslots)}
        for b in range(nblocks):
            j = sum(1 for f in fb if f <= b) - 1
            cover[j].append(b - fb[j])
        counts = {len(ks) for ks in cover.values()}
        assert a.each == (counts.pop() if len(counts) == 1 else 0)
        assert nslots != 32 or a.each
        for b in range(nblocks if a.each else 0):
            assert b - fb[b // a.each] == b % a.each
        for j, i in enumerate(run):
            rec = a.slot[j]
            assert (rec.head, rec.width, rec.units, rec.tail) == plan[i]
            assert rec.off == offs[i]
            assert (rec.src or None) == (None if zero[i] else srcs[i])
            ks = cover[j]
            assert ks == list(range(len(ks)))
            per = units * 16 // rec.width
            spans = [(k * per, min(k * per + per, rec.units)) for k in ks]
            assert sum(e - s for s, e in spans) == rec.units
            if rec.units:
                assert all(s < e for s, e in spans)
            else:
                assert ks == ([0] if rec.head + rec.tail else [])


def _pack_by_plan(xs, zero):
    """K7's plan executed with torch slicing on the CPU: head and tail
    byte by byte, the body viewed at its width on both sides (a view
    that only an aligned address allows)."""
    isz = xs[0].element_size()
    nbytes = [x.numel() * isz for x in xs]
    out = torch.empty(sum(x.numel() for x in xs), dtype=xs[0].dtype)
    ob = out.view(torch.uint8)
    offs = np.concatenate([[0], np.cumsum(nbytes)[:-1]]).tolist()
    plan = mesh._pack_plan([x.data_ptr() for x in xs], nbytes,
                           out.data_ptr(), offs, zero)
    for x, z, off, (head, w, units, tail) in zip(xs, zero, offs, plan):
        src = torch.zeros(x.numel() * isz, dtype=torch.uint8) if z \
            else x.reshape(-1).view(torch.uint8)
        dst = ob[off:off + src.numel()]
        end = head + units * w
        dst[:head] = src[:head]
        if units:
            d, s = dst[head:end], src[head:end]
            assert d.data_ptr() % 16 == 0
            d = d.view(torch.int64).view(-1, 2) if w == 16 \
                else d.view(_UNIT[w])
            if z:
                d.zero_()
            else:
                assert s.data_ptr() % w == 0
                d.copy_(s.view(torch.int64).view(-1, 2) if w == 16
                        else s.view(_UNIT[w]))
        dst[end:] = src[end:]
    return out


PACK_DTYPES = [torch.uint8, torch.int16, torch.float32, torch.float64,
               torch.complex128]


@pytest.mark.parametrize("nslots", [9, 64])
@pytest.mark.parametrize("dtype", PACK_DTYPES, ids=lambda d: str(d)[6:])
def test_pack_plan_executed_gives_plain_bytes(dtype, nslots):
    """Slots whose sources are skewed from their packed places by 0, 1,
    2, 4, 8 and 12 bytes (each the dtype's size divides), empty and zero
    slots: the plan, executed with torch slicing, writes
    ``slot_pack_plain``'s bytes."""
    isz = torch.empty((), dtype=dtype).element_size()
    skews = [k for k in (0, 1, 2, 4, 8, 12) if k % isz == 0]
    sizes = (0, 1, 3, 15, 16, 17, 49, 4097)
    rng = np.random.default_rng(isz * 100 + nslots)
    xs, off = [], 0
    for i in range(nslots):
        n = sizes[i % len(sizes)]
        base = torch.from_numpy(rng.integers(0, 256, (n + 16) * isz,
                                             dtype=np.uint8)).view(dtype)
        assert base.data_ptr() % 16 == 0
        a = (off - skews[i % len(skews)]) % 16 // isz
        xs.append(base[a:a + n])
        off += n * isz
    for zero in ([False] * nslots, [i % 3 == 1 for i in range(nslots)]):
        got = _pack_by_plan(xs, zero)
        want = mesh.slot_pack_plain(xs, zero)
        assert got.view(torch.uint8).tolist() == \
            want.view(torch.uint8).tolist()


# ---------------------------------------------------------------------------
# K9: rma._acc_split
# ---------------------------------------------------------------------------

WIRE = list(rma.WIRE_DTYPES)


def _isz(dt):
    return torch.empty((), dtype=dt).element_size()


@pytest.mark.parametrize("dt", WIRE, ids=lambda d: str(d)[6:])
def test_acc_split_alignment_facts(dt):
    """Counts 1, V - 1, V, V + 1, 1029 and 4096 * 8 + 5, w and s at
    every residue modulo 16, old absent or at every residue: head, body
    and tail make up the op, the head and the tail under one vector; an
    element-aligned w's head ends at its first 16-byte boundary (or the
    op), a w that is not takes no head and mode 0 (bytes); every
    operand's mode is the widest that holds for it, 2 at the body's
    start 16-byte aligned, 1 element-aligned, 0 neither."""
    isz = _isz(dt)
    v = 16 // isz
    for count in sorted({1, max(1, v - 1), v, v + 1, 1029, 4096 * 8 + 5}):
        for rw in range(16):
            for rs in range(16):
                for ro in [None] + list(range(16)):
                    w, s = 4096 + rw, 8192 + rs
                    old = None if ro is None else 12288 + ro
                    at = (count, rw, rs, ro)
                    head, nvec, tail, wm, sm, om = rma._acc_split(
                        w, s, old, count, isz)
                    assert 0 <= head < v and 0 <= tail < v, at
                    assert head + nvec * v + tail == count, at
                    body = head * isz
                    if w % isz:
                        assert head == 0 and wm == 0, at
                    else:
                        assert wm == 2, at
                        if head < count:
                            assert (w + body) % 16 == 0, at
                        else:
                            assert all((w + h * isz) % 16
                                       for h in range(count)), at
                    for p, m in ((s, sm), (old, om)):
                        if p is None:
                            assert m is None, at
                            continue
                        facts = ((p + body) % 16 == 0, p % isz == 0)
                        assert m == (2 if facts[0] else 1 if facts[1]
                                     else 0), at


def _acc_values(rng, n, dt):
    if dt == torch.bool:
        return torch.from_numpy(rng.integers(0, 3, n, dtype=np.uint8)
                                ).view(torch.bool)
    if dt.is_complex:
        return torch.from_numpy(rng.standard_normal(2 * n)).view(
            torch.complex128).to(dt)
    if dt.is_floating_point:
        return torch.from_numpy(rng.standard_normal(n)).to(dt)
    info = torch.iinfo(dt)
    return torch.from_numpy(rng.integers(max(info.min, -2 ** 62),
                                         min(info.max, 2 ** 62), n)).to(dt)


@pytest.mark.parametrize("dt", WIRE, ids=lambda d: str(d)[6:])
def test_acc_split_executed_gives_plain_bytes(dt):
    """The split executed with torch slicing on the CPU — the head, the
    body as (vectors, V) elements, the tail, each one call of the plain
    version at its own byte offset — gives one plain call's bytes, at
    starts 0, isz, 1, 4, 16 - isz and 17 bytes, s and old one element
    off in turn, plain and fetch, for SUM (or LOR on bool) and
    REPLACE."""
    isz = _isz(dt)
    v = 16 // isz
    op = "MPI_LOR" if dt == torch.bool else "MPI_SUM"
    rng = np.random.default_rng(60 + WIRE.index(dt))
    for k, start in enumerate(sorted({0, isz, 1, 4, 16 - isz, 17})):
        for count in (1, v + 1, 1029):
            s_off, o_off = k % 2, (k + 1) % 2
            nb = count * isz
            w0 = torch.from_numpy(rng.integers(0, 256, start + nb + 5,
                                               dtype=np.uint8))
            w0[start:start + nb] = _acc_values(rng, count, dt).view(
                torch.uint8)
            s = _acc_values(rng, count + s_off, dt)[s_off:]
            for opname in (op, "MPI_REPLACE"):
                for fetch in (False, True):
                    old = torch.empty(count + o_off, dtype=dt)[o_off:] \
                        if fetch else None
                    head, nvec, tail, *_ = rma._acc_split(
                        w0.data_ptr() + start, s.data_ptr(),
                        None if old is None else old.data_ptr(), count, isz)
                    got = w0.clone()
                    for e0, e1 in ((0, head), (head, head + nvec * v),
                                   (head + nvec * v, count)):
                        if e1 > e0:
                            part = s[e0:e1]
                            if e0 == head and e1 - e0 == nvec * v:
                                part = part.view(nvec, v)
                            rma.rma_acc_plain(
                                got, start + e0 * isz,
                                part.reshape(-1), opname,
                                None if old is None else old[e0:e1])
                    got_old = None if old is None else \
                        old.view(torch.uint8).clone()
                    want = w0.clone()
                    want_old = None if old is None else \
                        torch.empty(count, dtype=dt)
                    rma.rma_acc_plain(want, start, s, opname, want_old)
                    assert got.tolist() == want.tolist(), \
                        (start, count, opname, fetch)
                    if fetch:
                        assert got_old.tolist() == \
                            want_old.view(torch.uint8).tolist()


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never while the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_planned_kernels_match_plain_on_card(cuda_device):
    """K7 over slot mixes skewed by 0 to 12 bytes (64 and 65 slots: one
    launch and two) and K9 at starts 0, isz, 1, 4, 16 - isz, 17 with s
    and old one element off, against their plain versions on the card:
    exact."""
    rng = np.random.default_rng(81)
    for dtype in PACK_DTYPES:
        isz = _isz(dtype)
        skews = [k for k in (0, 1, 2, 4, 8, 12) if k % isz == 0]
        for nslots in (64, 65):
            xs, off = [], 0
            for i in range(nslots):
                n = (0, 1, 17, 49, 16385)[i % 5]
                base = _acc_values(rng, n + 16, dtype).to(cuda_device)
                a = (off - skews[i % len(skews)]) % 16 // isz
                xs.append(base[a:a + n])
                off += n * isz
            zero = [i % 3 == 1 for i in range(nslots)]
            before = mesh.slot_pack.launches.value
            got = mesh.slot_pack(xs, zero)
            assert mesh.slot_pack.launches.value - before == \
                -(-nslots // mesh.MAX_SLOTS)
            assert torch.equal(got.view(torch.uint8),
                               mesh.slot_pack_plain(xs, zero).view(
                                   torch.uint8))
    for dt in WIRE:
        isz = _isz(dt)
        for k, start in enumerate(sorted({0, isz, 1, 4, 16 - isz, 17})):
            count = 1029
            w0 = torch.from_numpy(rng.integers(0, 256, start + count * isz
                                               + 5, dtype=np.uint8))
            w0 = w0.to(cuda_device)
            s = _acc_values(rng, count + 1, dt).to(cuda_device)[k % 2:][
                :count]
            old = torch.empty(count + 1, dtype=dt,
                              device=cuda_device)[(k + 1) % 2:][:count]
            a, b = w0.clone(), w0.clone()
            want_old = torch.empty(count, dtype=dt, device=cuda_device)
            rma.rma_acc(a, start, s, "MPI_REPLACE", old)
            rma.rma_acc_plain(b, start, s, "MPI_REPLACE", want_old)
            assert torch.equal(a, b)
            assert torch.equal(old.view(torch.uint8),
                               want_old.view(torch.uint8))
    torch.cuda.synchronize()
