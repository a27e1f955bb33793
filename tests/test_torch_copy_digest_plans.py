"""The plans of K8 rma_copy and K11 digest (ompi_tpu_torch/kernels/
rma.py ``_copy_plan``, digest.py ``_plan`` / ``blocks`` / ``_slot``).

Each kernel is launched from what its wrapper works out in Python from
integer addresses, so that is what the CPU can hold:

- K8 splits a copy on the destination's alignment: head bytes up to
  dst's first 16-byte boundary, whole 16-byte destination words, tail
  bytes, and the source's shift inside its first aligned 16-byte word;
  every store of the body is an aligned word, and the aligned source
  words the kernel reads stay inside the 16-byte granules of the span;
- K11 gives an operand its blocks from its length and width alone, so
  the fold order never depends on the address; the address picks only
  the load mode (16-byte words on a 16-byte-aligned base, else element
  by element); each (device, stream) has a row of done counters of its
  own.

K8's plan is held to its alignment facts at every residue modulo 16 and
executed here with torch slicing (head, body words assembled from
neighbouring aligned source words at the shift, tail), which must give
``rma_copy_plain``'s bytes.  K11's plain version is held against the
reference's ``integrity.digest`` on views at element offsets 0..3:
exact for INTSUM, MAX and MIN, within 1e-12 relative for FSUM (float64
sums in two orders).  The kernels themselves are held against the plain
versions on the card by the gpu-marked test at the end (skipped without
a card).
"""

import numpy as np
import pytest
import torch

from ompi_tpu.obs import integrity as ref_ig
from ompi_tpu_torch.kernels import digest as k11
from ompi_tpu_torch.kernels import rma

COPY_SIZES = (1, 15, 16, 17, 31, 4096 + 13, 65536 + 13)


def _ceil16(x):
    return -(-x // 16) * 16


@pytest.mark.parametrize("n", COPY_SIZES)
def test_copy_plan_alignment_facts(n):
    """Destination and source at every residue modulo 16 (near 4 KiB and
    near 2**40): head, body and tail make up the copy, the head and the
    tail under 16 bytes; the head ends at dst's first 16-byte boundary
    (or takes every byte when the span holds none), so every body word
    is 16-byte aligned; the shift is where the body's first source byte
    sits in its aligned word; and the aligned source words read for the
    body (one more than the words when the shift is not 0) lie inside
    the 16-byte granules that hold the span's bytes."""
    for base in (4096, 1 << 40):
        for rd in range(16):
            for rs in range(16):
                d, s = base + rd, 2 * base + rs
                at = (n, base, rd, rs)
                head, words, tail, shift = rma._copy_plan(d, s, n)
                assert head + 16 * words + tail == n, at
                assert 0 <= head < 16 and 0 <= tail < 16, at
                assert all((d + h) % 16 for h in range(head)), at
                if head < n:
                    assert (d + head) % 16 == 0, at
                else:
                    assert words == 0 and tail == 0, at
                assert shift == (s + head) % 16, at
                if words:
                    first = s + head - shift
                    last = first + 16 * (words + (shift > 0))
                    assert first % 16 == 0, at
                    assert first >= s // 16 * 16, at
                    assert last <= _ceil16(s + n), at


@pytest.mark.parametrize("n", COPY_SIZES)
def test_copy_plan_executed_gives_plain_bytes(n):
    """For every (dst, src) skew modulo 16, the plan executed with torch
    slicing on the CPU — head bytes, each body word bytes [shift, shift
    + 16) of two neighbouring aligned source words, tail bytes — writes
    the bytes of one ``rma_copy_plain`` call, and nothing outside the
    span.  The source tensor ends at the granule of its last span byte,
    so every aligned word read lies inside it."""
    rng = np.random.default_rng(90 + n % 97)
    for rd in range(16):
        for rs in range(16):
            src = torch.from_numpy(rng.integers(0, 256, _ceil16(rs + n),
                                                dtype=np.uint8))
            dst = torch.from_numpy(rng.integers(0, 256, rd + n + 16,
                                                dtype=np.uint8))
            assert src.data_ptr() % 16 == 0 and dst.data_ptr() % 16 == 0
            head, words, tail, shift = rma._copy_plan(
                dst.data_ptr() + rd, src.data_ptr() + rs, n)
            got = dst.clone()
            got[rd:rd + head] = src[rs:rs + head]
            if words:
                a0 = rs + head - shift
                w = src[a0:a0 + 16 * (words + (shift > 0))].view(-1, 16)
                if shift:
                    w = torch.cat([w[:-1], w[1:]], dim=1)[:, shift:shift + 16]
                b0 = rd + head
                got[b0:b0 + 16 * words] = w.reshape(-1)
            t0 = head + 16 * words
            got[rd + t0:rd + n] = src[rs + t0:rs + n]
            want = rma.rma_copy_plain(dst.clone(), rd, src, rs, n)
            assert torch.equal(got, want), (n, rd, rs)


DIGEST_DTYPES = [torch.int8, torch.uint8, torch.int16, torch.uint16,
                 torch.int32, torch.uint32, torch.int64, torch.uint64,
                 torch.float16, torch.float32, torch.float64]


def _isz(dt):
    return torch.empty((), dtype=dt).element_size()


@pytest.mark.parametrize("dt", DIGEST_DTYPES, ids=lambda d: str(d)[6:])
def test_digest_plan_address_picks_only_the_load_mode(dt):
    """At every element-aligned address residue modulo 16 (near 4 KiB
    and near 2**40), an operand's blocks and groups are the same — so
    is the fold order they fix — and only the load mode follows the
    address: 16-byte words exactly where the base is 16-byte aligned.
    The groups hold every element once (16 // isz a group, the last one
    partial); the blocks cover the groups in spans of THREADS * U, one
    at least, MAX_BLOCKS at most."""
    isz = _isz(dt)
    v = 16 // isz
    span = k11.THREADS * k11.U
    for n in sorted({0, 1, v - 1, v, v + 1, (1 << 17) + 3, (8 << 20) // isz,
                     (128 << 20) // isz + 1}):
        plans = {}
        for base in (4096, 1 << 40):
            for r in range(0, 16, isz):
                nb, groups, vec = k11._plan(base + r, n, isz)
                assert vec == int(r == 0), (n, r)
                plans[base, r] = (nb, groups)
        assert len(set(plans.values())) == 1, (n, plans)
        nb, groups = plans[4096, 0]
        assert nb == k11.blocks(n, isz)
        assert groups * v >= n > (groups - 1) * v, n
        assert 1 <= nb <= k11.MAX_BLOCKS, n
        if nb < k11.MAX_BLOCKS:
            assert nb * span >= groups and (nb - 1) * span < max(groups, 1)
        else:
            assert nb * span <= groups, n


def test_digest_slots_one_a_device_and_stream():
    """Each (device, stream) gets a row of done counters of its own,
    numbered per device from 0; the same stream always gets its row; a
    device with more than SLOTS streams is refused (a shared row would
    race between streams)."""
    saved = dict(k11._slots)
    try:
        k11._slots.clear()
        d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
        assert [k11._slot(d0, s) for s in (11, 12, 13)] == [0, 1, 2]
        assert k11._slot(d1, 11) == 0 and k11._slot(d1, 99) == 1
        assert k11._slot(d0, 12) == 1 and k11._slot(d1, 11) == 0
        for s in range(100, 100 + k11.SLOTS - 3):
            k11._slot(d0, s)
        with pytest.raises(RuntimeError, match="streams"):
            k11._slot(d0, 1 << 40)
        assert k11._slot(d1, 1 << 40) == 2
    finally:
        k11._slots.clear()
        k11._slots.update(saved)


def _operand(rng, dt, n):
    """n values of dt: floats with signed zeros and infinities, integers
    over their whole range."""
    if dt.is_floating_point:
        a = rng.standard_normal(n) * 1000
        if n >= 8:
            a[1], a[3], a[5] = -0.0, np.inf, -np.inf
        return torch.from_numpy(a).to(dt)
    info = torch.iinfo(dt)
    lo, hi = max(info.min, -2 ** 63), min(info.max, 2 ** 63 - 1)
    return torch.from_numpy(rng.integers(lo, hi, n, dtype=np.int64,
                                         endpoint=True)).to(dt) \
        if dt != torch.uint64 else torch.from_numpy(
            rng.integers(0, 2 ** 64 - 1, n, dtype=np.uint64, endpoint=True
                         ).view(np.int64)).view(torch.uint64)


def _same(code, got, want):
    if code == k11.F_FSUM and not (np.isinf(want) or np.isnan(want)):
        return abs(got - want) <= 1e-12 * max(abs(got), abs(want))
    return got == want or (got != got and want != want)


@pytest.mark.parametrize("dt", DIGEST_DTYPES, ids=lambda d: str(d)[6:])
def test_digest_plain_matches_reference_at_element_offsets(dt):
    """The same values as a view at element offsets 0..3 of a larger
    buffer (lengths 1, 1000 and 2**17 + 3; a second float operand finite,
    so that its FSUM is a number): ``digest_plain`` gives the reference's
    ``integrity.digest`` of the numpy array — INTSUM, MAX and MIN exactly,
    FSUM within 1e-12 relative — and INTSUM, MAX and MIN the same bits at
    every offset."""
    rng = np.random.default_rng(70 + DIGEST_DTYPES.index(dt))
    fl = dt.is_floating_point
    codes = ((k11.F_FSUM, k11.F_MAX, k11.F_MIN) if fl
             else (k11.F_INTSUM, k11.F_MAX, k11.F_MIN))
    ops = [_operand(rng, dt, n) for n in (1, 1000, (1 << 17) + 3)]
    if fl:
        ops.append(torch.nan_to_num(ops[-1], posinf=7.0, neginf=-7.0))
    for x in ops:
        a = x.numpy()
        for code in codes:
            want = ref_ig.digest(a, code)
            seen = set()
            for off in range(4):
                buf = torch.zeros(x.numel() + 4, dtype=dt)
                view = buf[off:off + x.numel()]
                view.copy_(x)
                raw = k11.digest_plain([view], [code])
                got = k11.decode(raw.tolist()[0], code, dt)
                assert _same(code, got, want), (x.numel(), code, off, got,
                                                want)
                seen.add(raw.tolist()[0])
            assert code == k11.F_FSUM or len(seen) == 1, (x.numel(), code)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never while the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_copy_and_digest_kernels_match_plain_on_card(cuda_device):
    """K8 at every destination shift against source offsets 0 and 3, at
    every size above, byte for byte against ``rma_copy_plain``; K11 on
    the same values at every element offset 0..V-1: identical bits, and
    against ``digest_plain`` (INTSUM, MAX, MIN exact, FSUM within 1e-12
    relative)."""
    rng = np.random.default_rng(91)
    for n in COPY_SIZES:
        for s_off in (0, 3):
            src = torch.from_numpy(rng.integers(0, 256, s_off + n,
                                                dtype=np.uint8)).to(
                cuda_device)
            for d_off in range(16):
                base = torch.from_numpy(rng.integers(0, 256, n + 32,
                                                     dtype=np.uint8)).to(
                    cuda_device)
                a = rma.rma_copy(base.clone(), d_off, src, s_off, n)
                b = rma.rma_copy_plain(base.clone(), d_off, src, s_off, n)
                assert torch.equal(a, b), (n, d_off, s_off)
    for dt in DIGEST_DTYPES:
        v = 16 // _isz(dt)
        x = _operand(rng, dt, (1 << 17) + 3).to(cuda_device)
        if dt.is_floating_point:
            x = torch.nan_to_num(x, posinf=7.0, neginf=-7.0)
        codes = ((k11.F_FSUM, k11.F_MAX, k11.F_MIN)
                 if dt.is_floating_point
                 else (k11.F_INTSUM, k11.F_MAX, k11.F_MIN))
        for code in codes:
            buf = torch.empty(x.numel() + v, dtype=dt, device=cuda_device)
            bits = set()
            for off in range(v):
                view = buf[off:off + x.numel()]
                view.copy_(x)
                got = k11.digest([view], [code]).tolist()[0]
                want = k11.digest_plain([view], [code]).tolist()[0]
                assert _same(code, k11.decode(got, code, dt),
                             k11.decode(want, code, dt)), (dt, code, off)
                bits.add(got)
            assert len(bits) == 1, (dt, code)
    torch.cuda.synchronize()
