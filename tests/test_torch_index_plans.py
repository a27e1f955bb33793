"""K5 index_scatter's plan (ompi_tpu_torch/kernels/index.py ``_runs``,
``_expand``, ``_checked``, ``IndexVector.runs``) and its run-mode plain
version ``index_scatter_runs_plain``.

An ``IndexVector`` splits its indices once on the host into affine runs
(first destination, block length, stride, block count, packed offset);
K5 takes run mode, reading no index, where the indices are distinct and
the table is shorter than the vector, and index mode otherwise.  So
that is what the CPU can hold:

- the planner on the element-index vectors of the engine's vector,
  hvector, indexed, subarray and contiguous types at several counts
  (the port's vectors equal the reference's ``element_indices``): run
  mode, and the table's expansion equals the vector exactly; config 5's
  ``vector(m, 1, 2)`` is one run, and ``datatype.device`` hands its
  unpack that table;
- permutations, repeated indices, an empty vector, one element and more
  runs than ``MAX_RUNS`` take index mode;
- a table that does not expand to its vector is refused;
- ``index_scatter_runs_plain`` (strided views of ``out``, no index
  read) against ``index_scatter_plain`` and the reference's scatter
  (``jnp...at[idx].set`` for 1-, 2- and 4-byte elements; numpy's fancy
  assignment for 8 and 16, which jnp would narrow with x64 off), byte
  for byte at widths 1, 2, 4, 8 and 16, ``out`` at element offsets 0
  and 1 into a buffer filled with a sentinel byte that every gap keeps.

The kernel itself, in both modes, is held against the plain version on
the card by the gpu-marked test at the end (skipped without a card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ompi_tpu.datatype import device as ref_dev
from ompi_tpu.datatype import engine as ref_dt
from ompi_tpu_torch.datatype import device as port_dev
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.kernels import index

CPU = torch.device("cpu")
SENTINEL = 0xA5


def _engine_types():
    """(name, constructor taking an engine module and its DOUBLE)."""
    return {
        "vector_stride2": lambda E, b: E.vector(64, 1, 2, b),
        "vector_blocks": lambda E, b: E.vector(12, 4, 6, b),
        "hvector": lambda E, b: E.hvector(10, 2, 56, b),
        "indexed": lambda E, b: E.indexed([8, 8, 8, 16], [0, 20, 40, 100],
                                          b),
        "subarray_2d": lambda E, b: E.subarray([10, 12], [4, 8], [3, 2],
                                               E.ORDER_C, b),
        "subarray_3d": lambda E, b: E.subarray([6, 10, 12], [3, 4, 8],
                                               [1, 2, 3], E.ORDER_C, b),
        "contiguous": lambda E, b: E.contiguous(50, b),
    }


@pytest.mark.parametrize("count", [1, 2, 3])
@pytest.mark.parametrize("name", list(_engine_types()))
def test_planner_expands_engine_types(name, count):
    make = _engine_types()[name]
    idx = port_dev.element_indices(make(port_dt, port_dt.DOUBLE).commit(),
                                   count)
    ref = ref_dev.element_indices(make(ref_dt, ref_dt.DOUBLE).commit(),
                                  count)
    np.testing.assert_array_equal(idx, ref)
    iv = index.IndexVector(idx, CPU)
    assert iv.mode == "runs", (name, count)
    assert iv.runs.size < idx.size and len(iv.runs) <= index.MAX_RUNS
    np.testing.assert_array_equal(index._expand(iv.runs), idx)
    assert index._checked(idx, iv.runs) is not None


@pytest.mark.parametrize("m", [6, 7, 1 << 10, 1 << 17])
def test_config5_vector_is_one_run(m):
    """Config 5's receive layout, vector(m, 1, 2, DOUBLE): one run, and
    the vector device_unpack hands K5 carries it."""
    vec = port_dt.vector(m, 1, 2, port_dt.DOUBLE).commit()
    iv = port_dev._index(vec, 1, CPU)
    assert iv.mode == "runs"
    assert iv.runs.tolist() == [[0, 1, 2, m, 0]]


def _blocks(k):
    """k blocks of 8 and 9 elements in turn, 1000 apart: k runs."""
    return np.concatenate([np.arange(8 + j % 2) + 1000 * j
                           for j in range(k)])


def _index_mode_cases():
    rng = np.random.default_rng(5)
    many = np.cumsum(rng.integers(2, 9, 200))  # 200 one-element blocks
    return {
        "permutation": rng.permutation(4096),
        "partial_permutation": rng.permutation(3000)[:1000],
        "repeated": np.array([4, 6, 8, 10, 12, 6, 14, 16, 18, 20, 22, 24]),
        "repeated_runs": np.concatenate([np.arange(0, 40, 2)] * 2),
        "empty": np.zeros(0, np.int64),
        "one_element": np.array([17]),
        "more_runs_than_cap": _blocks(index.MAX_RUNS + 1),
        "short_blocks": many,
        "two_elements": np.array([3, 9]),
    }


@pytest.mark.parametrize("name", list(_index_mode_cases()))
def test_index_mode_cases(name):
    idx = _index_mode_cases()[name]
    iv = index.IndexVector(idx, CPU)
    assert iv.mode == "index" and iv.runs is None
    assert iv.n == idx.size
    with pytest.raises(ValueError):
        index.index_scatter_runs_plain(torch.zeros(iv.n), iv,
                                       torch.zeros(64 + 2 * iv.n))


def test_more_runs_than_cap_checked_at_the_cap():
    """MAX_RUNS runs are taken; one more is not."""
    iv = index.IndexVector(_blocks(index.MAX_RUNS), CPU)
    assert iv.mode == "runs" and len(iv.runs) == index.MAX_RUNS
    assert index.IndexVector(_blocks(index.MAX_RUNS + 1), CPU).runs is None


def _bad_tables():
    good = np.array([[0, 3, 10, 3, 0], [50, 3, 10, 2, 9]], np.int64)
    out = {}
    for name, (r, c, v) in {"dst": (1, 0, 51), "blen": (0, 1, 2),
                            "stride": (0, 2, 11), "nblk": (1, 3, 3),
                            "poff": (1, 4, 8), "zero_blen": (0, 1, 0)
                            }.items():
        t = good.copy()
        t[r, c] = v
        out[name] = t
    out["empty"] = good[:0]
    out["dropped_run"] = good[:1]
    out["swapped"] = good[::-1].copy()
    out["over_cap"] = np.tile(good[:1], (index.MAX_RUNS + 1, 1))
    return good, out


@pytest.mark.parametrize("name", list(_bad_tables()[1]))
def test_table_that_does_not_expand_is_refused(name):
    good, bad = _bad_tables()
    idx = index._expand(good)
    assert index._checked(idx, good) is not None
    with pytest.raises(ValueError):
        index._checked(idx, bad[name])


def test_planner_random_layouts():
    """Random sums of affine runs (rising and falling strides, some
    shuffled): every table the planner gives expands to its vector, and
    where run mode is taken the strided views write what the index
    scatter writes."""
    rng = np.random.default_rng(23)
    taken = 0
    for _ in range(400):
        parts = []
        for _ in range(int(rng.integers(1, 6))):
            bl, nb = (int(x) for x in rng.integers(1, 6, 2))
            st = int(rng.choice([-1, 1]) * rng.integers(1, 12))
            d = int(rng.integers(0, 300))
            parts.append((d + st * np.arange(nb)[:, None]
                          + np.arange(bl)[None, :]).reshape(-1))
        idx = np.concatenate(parts)
        idx -= idx.min()
        if rng.random() < 0.3:
            idx = rng.permutation(idx)[:max(1, idx.size // 2)]
        table = index._runs(idx)
        if table is not None:
            np.testing.assert_array_equal(index._expand(table), idx)
        iv = index.IndexVector(idx, CPU)
        if iv.runs is None:
            continue
        taken += 1
        pk = torch.arange(1, iv.n + 1, dtype=torch.float64)
        out = torch.full((iv.hi + 3,), -5.0, dtype=torch.float64)
        assert torch.equal(
            index.index_scatter_runs_plain(pk, iv, out.clone()),
            index.index_scatter_plain(pk, iv, out.clone()))
    assert taken > 50


WIDTH_DTYPES = {1: np.int8, 2: np.float16, 4: np.float32, 8: np.float64,
                16: np.complex128}


def _run_cases():
    """Index vectors that take run mode: (vector, span of out)."""
    w16 = np.concatenate([np.arange(8) + 24 * k for k in range(9)])
    return {
        "stride2": (np.arange(0, 256, 2), 257),
        "contiguous_blocks_of_words": (w16, 9 * 24),
        "falling": (np.arange(300, 0, -3), 301),
        "subarray_3d": (ref_dev.element_indices(ref_dt.subarray(
            [6, 10, 12], [3, 4, 8], [1, 2, 3], ref_dt.ORDER_C,
            ref_dt.DOUBLE).commit(), 1), 720),
        "two_interleaved": (np.concatenate([np.arange(0, 96, 4),
                                            np.arange(2, 96, 4)]), 97),
    }


def _sentinel_out(span, dt, off):
    """``span`` elements of dt at element offset ``off`` into a buffer
    of sentinel bytes (one spare element each side)."""
    buf = np.full((span + 2) * np.dtype(dt).itemsize, SENTINEL, np.uint8)
    t = torch.from_numpy(buf).view(
        torch.from_numpy(np.zeros(1, dt)).dtype)
    return t, t[off:off + span]


@pytest.mark.parametrize("off", [0, 1])
@pytest.mark.parametrize("case", list(_run_cases()))
@pytest.mark.parametrize("width", sorted(WIDTH_DTYPES))
def test_runs_plain_matches_plain_and_reference(width, case, off):
    dt = WIDTH_DTYPES[width]
    idx, span = _run_cases()[case]
    iv = index.IndexVector(idx, CPU)
    assert iv.mode == "runs", case
    rng = np.random.default_rng(width * 100 + off)
    vals = (rng.standard_normal(iv.n) * 100).astype(dt)
    if np.issubdtype(dt, np.complexfloating):
        vals = vals + 1j * (rng.standard_normal(iv.n) * 10).astype(dt)
    packed = torch.from_numpy(vals)
    bufs = []
    for f in (index.index_scatter_runs_plain, index.index_scatter_plain):
        buf, out = _sentinel_out(span, dt, off)
        assert f(packed, iv, out) is out
        bufs.append(buf.view(torch.uint8).numpy().copy())
    assert bufs[0].tobytes() == bufs[1].tobytes()
    fill = _sentinel_out(span, dt, off)[1].numpy().copy()
    if width <= 4:
        want = np.asarray(jnp.asarray(fill).at[jnp.asarray(idx)].set(
            jnp.asarray(vals)))
    else:
        want = fill.copy()
        want[idx] = vals
    got = bufs[0].view(dt)[off:off + span]
    assert got.tobytes() == want.tobytes()
    gaps = np.ones(span, bool)
    gaps[idx] = False
    every = bufs[0].reshape(span + 2, width)
    assert (every[off:off + span][gaps] == SENTINEL).all()
    assert (every[:off] == SENTINEL).all()
    assert (every[off + span:] == SENTINEL).all()


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never while the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_scatter_kernel_both_modes_match_plain_on_card(cuda_device):
    """K5 in run mode and index mode at every width, ``out`` at element
    offsets 0 and 1 into a sentinel buffer and the packed stream at
    element offsets 0 and 1: byte for byte against
    ``index_scatter_plain``, gap bytes unchanged, one launch a call in
    the mode the plan names; a table altered to reach past the vector's
    bounds raises before it launches."""
    cases = dict(_run_cases())
    cases.update((k, (v, int(v.max()) + 1 if v.size else 1))
                 for k, v in _index_mode_cases().items()
                 if k not in ("repeated", "repeated_runs"))
    rng = np.random.default_rng(77)
    for width, dt in WIDTH_DTYPES.items():
        for name, (idx, span) in cases.items():
            iv = index.IndexVector(idx, cuda_device)
            raw = (rng.standard_normal(iv.n + 1) * 50).astype(dt)
            for poff in (0, 1):
                packed = torch.from_numpy(raw).to(cuda_device)[
                    poff:poff + iv.n]
                for off in (0, 1):
                    buf = _sentinel_out(span, dt, off)[0].to(cuda_device)
                    out = buf[off:off + span]
                    want = buf.clone()
                    index.index_scatter_plain(packed, iv,
                                              want[off:off + span])
                    r0 = index.index_scatter.run_launches.value
                    n0 = index.index_scatter.launches.value
                    index.index_scatter(packed, iv, out)
                    torch.cuda.synchronize()
                    assert torch.equal(buf.view(torch.uint8),
                                       want.view(torch.uint8)), \
                        (width, name, poff, off)
                    assert index.index_scatter.launches.value - n0 \
                        == (1 if iv.n else 0)
                    assert index.index_scatter.run_launches.value - r0 \
                        == (1 if iv.mode == "runs" else 0)
    iv = index.IndexVector(np.arange(0, 64, 2), cuda_device)
    iv.runs = iv.runs.copy()
    iv.runs[0, index.DST] = 1  # its last element would land on 64
    out = torch.zeros(64, dtype=torch.float64, device=cuda_device)
    with pytest.raises(RuntimeError):
        index.index_scatter(torch.ones(32, dtype=torch.float64,
                                       device=cuda_device), iv, out)
    torch.cuda.synchronize()
    assert not out.any()
