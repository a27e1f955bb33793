"""The port's stacked kernels (ompi_tpu_torch/kernels/stacked.py) held
against the reference package's own stacked programs.

On the CPU the wrappers run their plain PyTorch versions; the
reference runs ``HbmCollModule._build_stacked(kind, op)[0]`` under
jax on the CPU.  Both get the same numpy inputs, made from a seed.

Tolerances:
  * float and complex SUM / PROD: a reassociation band.  float32 and
    complex64 (and float64 / complex128, which the reference computes
    in float32 / complex64 because x64 is off): |port - ref| <= 4 * N
    * 2**-24 * sum(|x_i|) for SUM, <= 4 * N * 2**-24 * |ref| for
    float PROD and <= 8 * N * 2**-24 * |ref| for complex PROD (each
    complex product rounds up to sqrt(5) units, not one).  float16 /
    bfloat16: one unit in the last place of the half-precision result.
    float64 and complex128 are also held against numpy in their own
    precision, with 2**-53 in place of 2**-24.
  * everything else byte for byte: integers, MAX / MIN, bitwise and
    logical ops, and all data movement.

Two reference behaviours are pinned as known divergences, not copied:
small-integer promotion (test_divergence_small_int_promotion) and
NaN propagation (test_nan_propagates_like_reference).

K3 ``fused_batch`` (kernels/fused.py) is held the same way against
the reference's fused hbm program (``coll/fusion._build_fused_hbm``),
slot by slot, with the tolerances above; its bcast entries are byte
for byte.  K4 ``index_gather`` and K5 ``index_scatter``
(kernels/index.py) are held byte for byte against the bodies of the
reference's ``device_pack`` (``jnp.take``) and ``device_unpack``
(``.at[idx].set``) for 1-, 2- and 4-byte elements, and against numpy's
take and fancy assignment for 8- and 16-byte ones (x64 off, jnp would
narrow them).

The mesh tier's kernels: K6 ``mesh_fold``'s plain version is held byte
for byte against the reference's own segring and segrd segment
programs (``coll/pipeline._build_seg_kernel`` on virtual devices),
float SUM and PROD included, since it folds each element in the same
order — but for float16, where the reference rounds every hop and K6
once (a pinned divergence, within 4 * N * 2**-11 * sum(|x_i|)); in
rank order it is K1's fold, byte for byte.  K2's peer mode
(``peer_copy``) and K7 ``slot_pack`` move bytes: exact (K7 against the
reference's ``_build_pack``).

The kernels themselves are held against their plain versions on the
card by the gpu-marked tests at the end (skipped without a card),
exact.
"""

import zlib

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.coll.device import HbmCollModule
from ompi_tpu.coll.fusion import _build_fused_hbm
from ompi_tpu_torch import convert
from ompi_tpu_torch.kernels import fused, index, mesh, stacked
from ompi_tpu_torch.op.op import PREDEFINED

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = [np.dtype(np.float16), BF16, np.dtype(np.float32),
          np.dtype(np.float64), np.dtype(np.int8), np.dtype(np.uint8),
          np.dtype(np.int32), np.dtype(np.int64), np.dtype(np.bool_),
          np.dtype(np.int16), np.dtype(np.uint16), np.dtype(np.uint32),
          np.dtype(np.uint64), np.dtype(np.complex64),
          np.dtype(np.complex128)]
OPS = ["MPI_SUM", "MPI_PROD", "MPI_MAX", "MPI_MIN", "MPI_LAND",
       "MPI_BAND", "MPI_LOR", "MPI_BOR", "MPI_LXOR", "MPI_BXOR"]
PAIRS = [(dt, op) for dt in DTYPES for op in OPS
         if PREDEFINED[op].valid_for(np.dtype(np.float32) if dt == BF16
                                     else dt)]


def _is_float(dt):
    """Floating point, complex included: the types with a band."""
    return dt.kind in "fc" or dt == BF16


def _shards(rng, n, length, dt, op):
    """n numpy shards of one dtype, shaped for the op (values that
    both packages represent exactly, products that stay finite)."""
    out = []
    for _ in range(n):
        if dt == np.bool_:
            a = rng.integers(0, 2, length).astype(np.bool_)
        elif dt.kind == "c":
            z = rng.standard_normal(length) + 1j * rng.standard_normal(length)
            a = 1.0 + 0.1 * z if op == "MPI_PROD" else z
            a = a.astype(np.complex64).astype(dt)  # as for floats below
        elif _is_float(dt):
            if op == "MPI_PROD":
                a = 1.0 + 0.1 * rng.standard_normal(length)
            else:
                a = rng.standard_normal(length)
            # float32-representable, so x64-off jax sees the same data
            a = a.astype(np.float32).astype(dt)
        elif op in ("MPI_LAND", "MPI_LOR", "MPI_LXOR"):
            a = rng.integers(0, 3, length).astype(dt)
        elif op == "MPI_PROD":
            a = rng.integers(0 if dt.kind == "u" else -3, 4,
                             length).astype(dt)
        elif dt.itemsize == 8:
            # int32-representable: the reference (x64 off) computes
            # int64 in int32 (uint64 in uint32), so stay where both agree
            lo = 0 if dt.kind == "u" else -2 ** 27
            a = rng.integers(lo, 2 ** 27, length).astype(dt)
        else:
            info = np.iinfo(dt)
            a = rng.integers(info.min, int(info.max) + 1,
                             length).astype(dt)
        out.append(a)
    return out


def _ref(kind, op, shards):
    """The reference's own stacked program on jnp arrays; returns a
    list of numpy outputs (one for allreduce/allgather, N otherwise)."""
    body = HbmCollModule._build_stacked(kind, op)[0]
    res = body(*[jnp.asarray(s) for s in shards])
    if isinstance(res, (tuple, list)):
        return [np.asarray(r) for r in res]
    return [np.asarray(res)]


def _port(kind, op, shards):
    xs = [convert.to_torch(s, torch.device("cpu")) for s in shards]
    if kind in ("allreduce", "reduce_scatter"):
        outs = stacked.stacked_reduce(xs, op, scatter=kind == "reduce_scatter")
    else:
        outs = stacked.stacked_copy(xs, kind)
    return [convert.to_numpy(o) for o in outs]


def _ulp(v, dt):
    """One unit in the last place of |v| in half precision dt."""
    mant = 10 if dt == np.float16 else 7
    a = np.abs(v.astype(np.float64))
    tiny = 2.0 ** (-14 if dt == np.float16 else -126)
    e = np.floor(np.log2(np.maximum(a, tiny)))
    return 2.0 ** (e - mant)


def assert_band(port, ref, absum, n, dt, op, unit=2.0 ** -24):
    """The float SUM/PROD band stated in the module docstring; absum
    is sum(|x_i|) at the same positions, unit the unit roundoff."""
    wide = np.complex128 if dt.kind == "c" else np.float64
    p = port.astype(wide)
    r = ref.astype(wide)
    if dt in (np.float16, BF16):
        tol = np.maximum(_ulp(p, dt), _ulp(r, dt))
    elif op == "MPI_SUM":
        tol = 4 * n * unit * absum
    else:
        tol = (8 if dt.kind == "c" else 4) * n * unit * np.abs(r)
    bad = np.abs(p - r) > tol
    assert not bad.any(), (dt, op, p[bad][:5], r[bad][:5])


def check_outputs(kind, op, shards, port, ref):
    dt = shards[0].dtype
    n = len(shards)
    if kind == "allreduce":
        # the reference hands every rank ONE array; the port one each
        assert len(port) == n and len(ref) == 1
        ref = ref * n
    assert len(port) == len(ref)
    absum = np.sum([np.abs(s).astype(np.float64) for s in shards], 0)
    own = None
    if dt in (np.float64, np.complex128) and op in ("MPI_SUM", "MPI_PROD"):
        # the reference ran in single precision: hold the port against
        # numpy in its own precision too, so a port that rounded
        # through single precision would fail
        own = np.sum(shards, 0) if op == "MPI_SUM" else np.prod(shards, 0)
    if kind == "reduce_scatter":
        parts = np.split(absum, n)
        owns = np.split(own, n) if own is not None else [None] * n
    else:
        parts = [absum] * n
        owns = [own] * n
    for p, r, a, o in zip(port, ref, parts, owns):
        assert p.dtype == dt  # MPI: the output has the input's type
        assert p.shape == r.shape
        r = r.astype(dt)  # pinned divergence: small-int promotion
        if _is_float(dt) and op in ("MPI_SUM", "MPI_PROD"):
            assert_band(p, r, a, n, dt, op)
            if o is not None:
                assert_band(p, o, a, n, dt, op, unit=2.0 ** -53)
        else:
            np.testing.assert_array_equal(p, r)


@pytest.mark.parametrize("dt,op", PAIRS,
                         ids=[f"{d.name}-{o[4:]}" for d, o in PAIRS])
def test_stacked_reduce_matches_reference(dt, op):
    """Every (dtype, op) pair Op.valid_for admits, both modes, at a
    ragged length (37 elements a stripe); the pairs take N = 2, 3 and
    8 in turn."""
    seed = zlib.crc32(f"{dt.name}{op}".encode())
    rng = np.random.default_rng(seed)
    n = (2, 3, 8)[PAIRS.index((dt, op)) % 3]
    shards = _shards(rng, n, n * 37, dt, op)
    for kind in ("allreduce", "reduce_scatter"):
        check_outputs(kind, op, shards, _port(kind, op, shards),
                      _ref(kind, op, shards))


@pytest.mark.parametrize("kind", ["alltoall", "allgather"])
@pytest.mark.parametrize("dt", [np.dtype(np.float32), np.dtype(np.int8),
                                BF16, np.dtype(np.int32),
                                np.dtype(np.bool_)], ids=lambda d: d.name)
def test_stacked_copy_matches_reference(kind, dt):
    """Data movement is byte for byte: 1-D, 2-D and 3-D shards."""
    rng = np.random.default_rng(7)
    for n, shape in ((3, (3 * 5,)), (2, (2, 3, 5))):
        shards = [s.reshape(shape) for s in
                  _shards(rng, n, int(np.prod(shape)), dt, "MPI_SUM")]
        port = _port(kind, "", shards)
        ref = _ref(kind, "", shards)
        if kind == "allgather":
            ref = ref * n
        assert len(port) == len(ref) == n
        for p, r in zip(port, ref):
            assert p.dtype == dt
            np.testing.assert_array_equal(p, r)


def test_divergence_small_int_promotion():
    """Known divergence, pinned: jnp.sum / jnp.prod in the reference's
    stacked program promote small integers (int8 -> int32, uint8 ->
    uint32, bool -> int32), so its hbm allreduce of an int8 buffer
    returns int32.  MPI says the output has the input's type: the
    port keeps int8 (wrapping), and the values agree after a cast."""
    rng = np.random.default_rng(3)
    for dt, promoted in ((np.int8, np.int32), (np.uint8, np.uint32),
                         (np.bool_, np.int32)):
        shards = _shards(rng, 4, 64, np.dtype(dt), "MPI_SUM")
        for op in ("MPI_SUM", "MPI_PROD"):
            (ref,) = _ref("allreduce", op, shards)
            port = _port("allreduce", op, shards)
            assert ref.dtype == promoted
            assert all(p.dtype == dt for p in port)
            np.testing.assert_array_equal(port[0], ref.astype(dt))


def test_nan_propagates_like_reference():
    """Pinned: the reference's jnp.max / jnp.min propagate NaN
    (max(nan, 1) = nan); CUDA's fmaxf / fminf would not.  The port
    follows the reference, in the plain version here and in the
    kernel (held against the plain version on the card)."""
    a = np.array([np.nan, 1.0, 2.0, -np.inf], np.float32)
    b = np.array([1.0, np.nan, np.nan, 3.0], np.float32)
    for op in ("MPI_MAX", "MPI_MIN"):
        for kind in ("allreduce", "reduce_scatter"):
            ref = _ref(kind, op, [a, b])
            port = _port(kind, op, [a, b])
            ref = ref * 2 if kind == "allreduce" else ref
            for p, r in zip(port, ref):
                np.testing.assert_array_equal(p, r)
        out = _port("allreduce", op, [a, b])[0]
        assert np.isnan(out[:3]).all()


def test_logical_ops_normalise_for_any_n():
    """LAND/LOR/LXOR results are 0/1 in the input dtype even for a
    single input; LXOR is the parity of the nonzero inputs."""
    xs = [torch.tensor([5, 0, -2], dtype=torch.int32)]
    assert stacked.stacked_reduce(xs, "MPI_LAND")[0].tolist() == [1, 0, 1]
    xs = [torch.tensor([5, 0, 3]), torch.tensor([7, 0, 0]),
          torch.tensor([1, 2, 0])]
    assert stacked.stacked_reduce(xs, "MPI_LXOR")[0].tolist() == [1, 1, 1]


def test_wrappers_refuse_what_the_kernels_do_not_take():
    f = torch.zeros(8)
    with pytest.raises(TypeError):
        stacked.stacked_reduce([f, f], "MPI_BAND")  # invalid pair
    with pytest.raises(TypeError):
        stacked.stacked_reduce([f.to(torch.complex64)] * 2, "MPI_MAX")
    with pytest.raises(TypeError):  # a dtype outside K1's table
        stacked.stacked_reduce([f.to(torch.float8_e4m3fn)] * 2, "MPI_SUM")
    with pytest.raises(ValueError):
        stacked.stacked_reduce([f, torch.zeros(4)], "MPI_SUM")
    with pytest.raises(ValueError):
        stacked.stacked_reduce([f[::2], f[::2]], "MPI_SUM")
    with pytest.raises(ValueError):
        stacked.stacked_reduce([torch.zeros(7)] * 2, "MPI_SUM",
                               scatter=True)
    with pytest.raises(ValueError):
        stacked.stacked_copy([torch.zeros(3)] * 2, "alltoall")
    with pytest.raises(ValueError):
        stacked.stacked_reduce([f] * (stacked.MAX_PTRS + 1), "MPI_SUM")


def test_every_output_is_its_own_tensor():
    xs = [torch.ones(8), torch.ones(8)]
    for outs in (stacked.stacked_reduce(xs, "MPI_SUM"),
                 stacked.stacked_copy(xs, "allgather")):
        ptrs = {o.data_ptr() for o in outs}
        assert len(ptrs) == len(outs)
        assert not ptrs & {x.data_ptr() for x in xs}


def test_plain_launches_are_not_counted():
    before = (stacked.stacked_reduce.launches.value,
              stacked.stacked_copy.launches.value)
    xs = [torch.ones(4), torch.ones(4)]
    stacked.stacked_reduce(xs, "MPI_SUM")
    stacked.stacked_copy(xs, "allgather")
    assert (stacked.stacked_reduce.launches.value,
            stacked.stacked_copy.launches.value) == before


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, at run time, never while the
    module is imported."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_kernel_matches_plain_on_card(cuda_device):
    """K1 over every pair and K2, against their plain versions on the
    card: exact (the same left fold in the same accumulation type),
    NaN included; aligned, ragged and misaligned (scalar path)."""
    rng = np.random.default_rng(11)
    for dt, op in PAIRS:
        for n, length, off in ((2, 4096 * 2, 0), (3, 37 * 3, 1),
                               (8, 1029 * 8, 0)):
            shards = _shards(rng, n, length + off, dt, op)
            xs = [convert.to_torch(s, cuda_device)[off:] for s in shards]
            for scatter in (False, True):
                got = stacked.stacked_reduce(xs, op, scatter)
                want = stacked.stacked_reduce_plain(xs, op, scatter)
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=0, atol=0,
                                               equal_nan=True)
            for kind in ("alltoall", "allgather"):
                got = stacked.stacked_copy(xs, kind)
                want = stacked.stacked_copy_plain(xs, kind)
                for g, w in zip(got, want):
                    torch.testing.assert_close(g, w, rtol=0, atol=0,
                                               equal_nan=True)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K3 fused_batch, K4 index_gather, K5 index_scatter: plain versions
# ---------------------------------------------------------------------------

def _fused_case(rng, n, dt, op):
    """A batch group of one (dtype, op): ragged fold slots, and for
    SUM a bcast entry (bcasts join their dtype's SUM group)."""
    slots = [(_shards(rng, n, m, dt, op), None) for m in (5, 37, 1)]
    if op == "MPI_SUM":
        slots.insert(1, (_shards(rng, n, 11, dt, op), n - 1))
    return slots


@pytest.mark.parametrize("dt,op", PAIRS,
                         ids=[f"{d.name}-{o[4:]}" for d, o in PAIRS])
def test_fused_batch_matches_reference(dt, op):
    """K3's plain version against the reference's fused hbm program
    over the same slots: every fold slot within K1's tolerances,
    every bcast entry byte for byte; every rank its own output."""
    rng = np.random.default_rng(zlib.crc32(f"fused{dt.name}{op}".encode()))
    n = (2, 3, 8)[PAIRS.index((dt, op)) % 3]
    slots = _fused_case(rng, n, dt, op)
    sig = tuple(("bcast", s[0].shape, dt.str, root) if root is not None
                else ("allreduce", s[0].shape, dt.str, op)
                for s, root in slots)
    ref = _build_fused_hbm(n, sig)(
        *[jnp.asarray(s) for shards, _ in slots for s in shards])
    port = fused.fused_batch(
        [([convert.to_torch(s, torch.device("cpu")) for s in shards], root)
         for shards, root in slots], op)
    assert len(port) == len(slots)
    for (shards, root), p_outs, r_out in zip(slots, port, ref):
        p_outs = [convert.to_numpy(o) for o in p_outs]
        if root is None:
            check_outputs("allreduce", op, shards, p_outs,
                          [np.asarray(r_out)])
        else:
            for p in p_outs:
                # x64 off: the reference holds 8- and 16-byte types in
                # 4 and 8 bytes; the inputs survive that exactly
                assert p.tobytes() == shards[root].tobytes()
                assert p.tobytes() == np.asarray(r_out).astype(dt).tobytes()
    ptrs = [o.data_ptr() for outs in port for o in outs]
    assert len(set(ptrs)) == len(ptrs)


def test_fused_batch_refuses_what_the_kernel_does_not_take():
    f = torch.zeros(4)
    with pytest.raises(TypeError):
        fused.fused_batch([([f, f], None)], "MPI_BAND")
    with pytest.raises(ValueError):
        fused.fused_batch([([f, f], None), ([f], None)], "MPI_SUM")
    with pytest.raises(ValueError):
        fused.fused_batch([([f, f], 2)], "MPI_SUM")
    with pytest.raises(ValueError):
        fused.fused_batch([([f, torch.zeros(4, dtype=torch.int32)], None)],
                          "MPI_SUM")
    with pytest.raises(ValueError):
        fused.fused_batch([([f[::2], f[::2]], None)], "MPI_SUM")
    before = fused.fused_batch.launches.value
    fused.fused_batch([([f, f], None)], "MPI_SUM")
    assert fused.fused_batch.launches.value == before


INDEX_DTYPES = [np.dtype(np.int8), np.dtype(np.float16),
                np.dtype(np.float32), np.dtype(np.float64),
                np.dtype(np.complex128)]


def _index_cases(rng, nbuf):
    """Vector (stride 2), indexed (a permutation of scattered blocks)
    and contiguous index vectors over an nbuf-element buffer."""
    perm = rng.permutation(nbuf)[:nbuf // 3]
    return [np.arange(0, nbuf, 2), perm, np.arange(nbuf)]


@pytest.mark.parametrize("dt", INDEX_DTYPES, ids=lambda d: d.name)
def test_index_gather_scatter_match_reference(dt):
    rng = np.random.default_rng(31)
    nbuf = 301
    buf = (rng.standard_normal(nbuf) * 100).astype(dt)
    for idx in _index_cases(rng, nbuf):
        iv = index.IndexVector(idx, torch.device("cpu"))
        got = convert.to_numpy(index.index_gather(
            convert.to_torch(buf, torch.device("cpu")), iv))
        if dt.itemsize <= 4:
            want = np.asarray(jnp.take(jnp.asarray(buf), jnp.asarray(idx),
                                       axis=0))
        else:
            want = np.take(buf, idx)
        assert got.dtype == dt and got.tobytes() == want.tobytes()
        fill = np.zeros(nbuf, dt)
        out = convert.to_torch(fill, torch.device("cpu"))
        res = index.index_scatter(
            convert.to_torch(want, torch.device("cpu")), iv, out)
        assert res is out
        if dt.itemsize <= 4:
            ref = np.asarray(jnp.asarray(fill).at[jnp.asarray(idx)].set(
                jnp.asarray(want)))
        else:
            ref = fill.copy()
            ref[idx] = want
        assert convert.to_numpy(out).tobytes() == ref.tobytes()


@pytest.mark.gpu
def test_fused_kernel_matches_plain_on_card(cuda_device):
    """K3 over every pair K1 takes, N = 2, 3 and 8, ragged slots and
    bcast entries, against its plain version on the card: exact."""
    rng = np.random.default_rng(12)
    for dt, op in PAIRS:
        for n in (2, 3, 8):
            slots = [([convert.to_torch(s, cuda_device) for s in shards],
                      root) for shards, root in _fused_case(rng, n, dt, op)]
            got = fused.fused_batch(slots, op)
            want = fused.fused_batch_plain(slots, op)
            for gs, ws in zip(got, want):
                for g, w in zip(gs, ws):
                    torch.testing.assert_close(g, w, rtol=0, atol=0,
                                               equal_nan=True)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_index_kernels_match_plain_on_card(cuda_device):
    """K4 and K5 over the five element widths and the three index
    shapes, against their plain versions on the card: exact."""
    rng = np.random.default_rng(13)
    for dt in INDEX_DTYPES:
        buf = convert.to_torch(
            (rng.standard_normal(4099) * 100).astype(dt), cuda_device)
        for idx in _index_cases(rng, 4099):
            iv = index.IndexVector(idx, cuda_device)
            g = index.index_gather(buf, iv)
            assert torch.equal(g, index.index_gather_plain(buf, iv))
            a = torch.zeros_like(buf)
            b = torch.zeros_like(buf)
            index.index_scatter(g, iv, a)
            index.index_scatter_plain(g, iv, b)
            assert torch.equal(a, b)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K6 mesh_fold, K2 peer mode, K7 slot_pack (the mesh tier)
# ---------------------------------------------------------------------------

# the reference runs its mesh schedules with x64 off: stay in the
# 32-bit types; (dtype, op) pairs cover floats, ints and logical ops
MESH_PAIRS = [(np.dtype(np.float32), "MPI_SUM"),
              (np.dtype(np.float32), "MPI_PROD"),
              (np.dtype(np.float32), "MPI_MAX"),
              (np.dtype(np.int32), "MPI_SUM"),
              (np.dtype(np.int32), "MPI_BAND"),
              (np.dtype(np.int32), "MPI_LXOR"),
              (np.dtype(np.uint8), "MPI_MIN")]


def _ref_schedule(kind, shards, seg, opname):
    """The reference's own segment program (coll/pipeline.py
    _build_seg_kernel) over one segment a rank, on as many virtual
    devices as shards; the replicated result as numpy."""
    import jax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    from ompi_tpu.coll.pipeline import _build_seg_kernel
    n = len(shards)
    mesh = Mesh(np.array(jax.devices()[:n]), ("r",))
    g = jax.device_put(np.concatenate(shards),
                       NamedSharding(mesh, P("r")))
    fn = _build_seg_kernel(kind, mesh, seg, shards[0].dtype, opname)
    return np.asarray(fn(g))[:seg]


@pytest.mark.parametrize("dt,op", MESH_PAIRS,
                         ids=[f"{d.name}-{o[4:]}" for d, o in MESH_PAIRS])
@pytest.mark.parametrize("kind", ["segring", "segrd"])
def test_mesh_fold_matches_reference_schedules(kind, dt, op):
    """K6's plain version in the segring order (the rotation over a
    segment's stripes) and in segrd's tree, against the reference's
    segment programs on the same shards: byte for byte, float SUM and
    PROD included — each element is the same chain of IEEE ops."""
    n, seg = 4, 4 * 37
    rng = np.random.default_rng(zlib.crc32(f"{kind}{dt.name}{op}".encode()))
    shards = _shards(rng, n, seg, dt, op)
    want = _ref_schedule(kind, shards, seg, op)
    order = ("ring", seg, seg // n) if kind == "segring" else "tree"
    xs = [convert.to_torch(s, torch.device("cpu")) for s in shards]
    for lo, length in ((0, seg), (5, 41)):  # a whole segment, a stripe
        got = mesh.mesh_fold_plain(xs, lo, length, op, order)
        assert convert.to_numpy(got).tobytes() == \
            want[lo:lo + length].tobytes()


def test_mesh_fold_rank_order_matches_stacked():
    """K6 in rank order over a stripe is K1's fold over the same
    elements, for every pair K1 takes."""
    rng = np.random.default_rng(23)
    for dt, op in PAIRS:
        shards = _shards(rng, 3, 40, dt, op)
        xs = [convert.to_torch(s, torch.device("cpu")) for s in shards]
        out = torch.empty(17, dtype=xs[0].dtype)
        mesh.mesh_fold(xs, out, 9, op)
        want = stacked.stacked_reduce_plain([x[9:26] for x in xs], op)[0]
        assert torch.equal(out.view(torch.uint8), want.view(torch.uint8))


def test_divergence_half_accumulation_in_schedules():
    """float16 SUM through segring: the reference rounds to float16 at
    every hop; K6 (like K1) accumulates in float32 and rounds once.
    The port's result is the float32 fold rounded once, and the two
    agree within the float16 SUM band, 4 * N * 2**-11 * sum(|x_i|)."""
    n, seg = 4, 4 * 64
    rng = np.random.default_rng(29)
    shards = [rng.standard_normal(seg).astype(np.float16) for _ in range(n)]
    ref = _ref_schedule("segring", shards, seg, "MPI_SUM")
    xs = [convert.to_torch(s, torch.device("cpu")) for s in shards]
    got = convert.to_numpy(mesh.mesh_fold_plain(
        xs, 0, seg, "MPI_SUM", ("ring", seg, seg // n)))
    m = seg // n
    f32 = np.empty(seg, np.float32)
    for c in range(n):
        acc = np.zeros(m, np.float32)
        for k in range(n):
            acc = acc + shards[(c + k) % n][c * m:(c + 1) * m]
        f32[c * m:(c + 1) * m] = acc
    assert got.tobytes() == f32.astype(np.float16).tobytes()
    absum = np.sum([np.abs(s.astype(np.float64)) for s in shards], 0)
    tol = 4 * n * 2.0 ** -11 * absum
    assert (np.abs(got.astype(np.float64) - ref) <= tol).all()
    assert got.tobytes() != ref.tobytes()  # the divergence shows


def test_peer_copy_plain_cases():
    """K2 peer mode's plain version: an alltoall destination equals
    stacked_copy's, a clipped gather of ragged stripes, and a column
    segment of every block written in place."""
    n = 4
    xs = [torch.arange(24, dtype=torch.int32) + 100 * r for r in range(n)]
    want = stacked.stacked_copy_plain(xs, "alltoall")
    for d in range(n):
        out = torch.empty(24, dtype=torch.int32)
        stacked.peer_copy(xs, out, 6, dst=d, src_stride=6)
        assert torch.equal(out, want[d])
    stripes = [torch.full((3,), r, dtype=torch.int32) for r in range(n)]
    out = torch.full((10,), -1, dtype=torch.int32)
    stacked.peer_copy(stripes, out, 3, limit=10)
    assert out.tolist() == [0, 0, 0, 1, 1, 1, 2, 2, 2, 3]
    out = torch.zeros(24, dtype=torch.int32)
    stacked.peer_copy(xs, out, 2, dst=1, src_stride=6, src_off=3,
                      out_stride=6, out_off=3)
    for j in range(n):
        assert out[6 * j + 3:6 * j + 5].tolist() == \
            xs[j][9:11].tolist()
        assert out[6 * j:6 * j + 3].tolist() == [0, 0, 0]
    with pytest.raises(ValueError, match="outside"):
        stacked.peer_copy(xs, torch.empty(5, dtype=torch.int32), 6)


def test_slot_pack_matches_reference():
    """K7's plain version against the reference's _build_pack body on
    the same slots: non-root bcast slots zeroed, the rest concatenated,
    byte for byte."""
    import jax
    from ompi_tpu.coll.fusion import _build_pack
    rng = np.random.default_rng(37)
    slots = [rng.integers(-9, 9, s).astype(np.int32)
             for s in ((3,), (2, 2), (1,), (5,))]
    roots = (None, False, True, None)
    fn = _build_pack(jax.devices()[0], None, list(range(4)), roots)
    want = np.asarray(fn(*[jnp.asarray(s) for s in slots]))
    got = mesh.slot_pack([convert.to_torch(s, torch.device("cpu"))
                          for s in slots], [r is False for r in roots])
    assert convert.to_numpy(got).tobytes() == want.tobytes()
    before = mesh.slot_pack.launches.value
    mesh.slot_pack([torch.ones(2)])
    assert mesh.slot_pack.launches.value == before


def _mesh_orders(n, seg):
    orders = ["rank", ("ring", seg, seg // n)]
    return orders + (["tree"] if n & (n - 1) == 0 else [])


@pytest.mark.gpu
def test_mesh_kernels_match_plain_on_card(cuda_device):
    """K6 over every pair K1 takes, in rank order, the segring order
    and (N a power of two) segrd's tree, N = 2, 3, 4, 8, aligned and
    misaligned stripes; K2 peer mode for alltoall, clipped gathers and
    column segments; K7 with zeroed slots and odd widths — each against
    its plain version on the card: exact, NaN included."""
    rng = np.random.default_rng(14)
    for dt, op in PAIRS:
        for n in (2, 3, 4, 8):
            seg = 64 * n
            shards = _shards(rng, n, 3 * seg + 5, dt, op)
            xs = [convert.to_torch(s, cuda_device) for s in shards]
            for order in _mesh_orders(n, seg):
                for lo, length in ((0, 3 * seg + 5), (seg, 77), (3, 50)):
                    out = torch.empty(length, dtype=xs[0].dtype,
                                      device=cuda_device)
                    mesh.mesh_fold(xs, out, lo, op, order)
                    want = mesh.mesh_fold_plain(xs, lo, length, op, order)
                    torch.testing.assert_close(out, want, rtol=0, atol=0,
                                               equal_nan=True)
    for dt in (np.dtype(np.float32), np.dtype(np.int8),
               np.dtype(np.float64)):
        n = 4
        xs = [convert.to_torch(s, cuda_device)
              for s in _shards(rng, n, 8 * 1031, dt, "MPI_SUM")]
        for kw in ({"block": 2062, "src_stride": 2062, "dst": 2},
                   {"block": 1031 * 8, "limit": 3 * 1031 * 8 + 5},
                   {"block": 7, "src_stride": 2062, "dst": 1,
                    "src_off": 3, "out_stride": 2062, "out_off": 3}):
            a = torch.zeros(n * 8 * 1031, dtype=xs[0].dtype,
                            device=cuda_device)
            b = a.clone()
            stacked.peer_copy(xs, a, **kw)
            stacked.peer_copy_plain(xs, b, **kw)
            assert torch.equal(a, b)
        slots = [x[:k] for x, k in zip(xs, (5, 1024, 0, 333))]
        for zero in ([False] * 4, [True, False, True, False]):
            assert torch.equal(mesh.slot_pack(slots, zero),
                               mesh.slot_pack_plain(slots, zero))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K8 rma_copy, K9 rma_acc, K10 rma_cas (kernels/rma.py): their plain
# versions against numpy — the reference's window applies accumulate
# and compare-and-swap with numpy on the host (ompi_tpu/osc/window.py
# _apply: Op.reduce, old[0] == cmp[0]) — byte for byte; complex PROD
# against (ac - bd, ad + bc) rounded part by part (the numpy here may
# fuse a product into the sum: a divergence pinned in
# test_torch_osc_device.py).
# ---------------------------------------------------------------------------

from ompi_tpu.op import op as ref_op  # noqa: E402
from ompi_tpu_torch.kernels import rma  # noqa: E402

WIRE = [np.dtype(t) for t in (
    np.uint8, np.int8, np.int16, np.uint16, np.int32, np.uint32,
    np.int64, np.uint64, np.float32, np.float64, np.complex64,
    np.complex128, np.bool_)]
RMA_OPS = OPS + ["MPI_REPLACE", "MPI_NO_OP"]


def _wire_values(rng, n, dt):
    """n values of a wire dtype: floats with NaN, signed zeros and
    infinities sprinkled in, bool as 0/1."""
    if dt == np.bool_:
        return rng.integers(0, 2, n).astype(np.bool_)
    if dt.kind == "f":
        x = rng.standard_normal(n).astype(dt)
        k = max(2, n // 8)
        x[rng.integers(0, n, k)] = rng.choice(
            np.array([np.nan, 0.0, -0.0, np.inf, -np.inf], dtype=dt), k)
        return x
    if dt.kind == "c":
        return (rng.standard_normal(n)
                + 1j * rng.standard_normal(n)).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)


def _numpy_acc(s, w, opname):
    if opname == "MPI_PROD" and s.dtype.kind == "c":
        out = np.empty_like(w)
        out.real = s.real * w.real - s.imag * w.imag
        out.imag = s.real * w.imag + s.imag * w.real
        return out
    return ref_op.PREDEFINED[opname].reduce(s, w.copy())


def test_rma_copy_plain_matches_numpy():
    rng = np.random.default_rng(21)
    for n, d_off, s_off in ((1, 0, 0), (17, 1, 3), (1000, 7, 16),
                            (4099, 16, 5)):
        src = rng.integers(0, 256, n + 16, dtype=np.uint8)
        dst = rng.integers(0, 256, n + 32, dtype=np.uint8)
        want = dst.copy()
        want[d_off:d_off + n] = src[s_off:s_off + n]
        t = torch.from_numpy(dst.copy())
        rma.rma_copy(t, d_off, torch.from_numpy(src), s_off, n)
        assert t.numpy().tobytes() == want.tobytes()
    with pytest.raises(ValueError):
        rma.rma_copy(torch.zeros(4, dtype=torch.uint8), 2,
                     torch.zeros(4, dtype=torch.uint8), 0, 3)


@pytest.mark.parametrize("dt", WIRE, ids=str)
def test_rma_acc_plain_matches_numpy(dt):
    """Every op the kernel takes on this dtype (exactly the pairs
    Op.valid_for admits, REPLACE and NO_OP included), plain and fetch,
    aligned and misaligned: numpy's bytes."""
    rng = np.random.default_rng(22 + WIRE.index(dt))
    tdt = torch.from_numpy(np.empty(0, dt)).dtype
    ops = [o for o in RMA_OPS if ref_op.PREDEFINED[o].valid_for(dt)]
    assert [o for o in RMA_OPS if rma.acc_supported(tdt, o)] == ops
    n = 67
    for opname in ops:
        for start in (0, dt.itemsize + 1):
            w = _wire_values(rng, n, dt)
            s = _wire_values(rng, n, dt)
            buf = np.zeros(start + w.nbytes + 5, np.uint8)
            buf[start:start + w.nbytes] = w.view(np.uint8)
            want = buf.copy()
            want[start:start + w.nbytes] = _numpy_acc(s, w, opname).view(
                np.uint8)
            for fetch in (False, True):
                t = torch.from_numpy(buf.copy())
                old = torch.empty(n, dtype=tdt) if fetch else None
                rma.rma_acc(t, start, torch.from_numpy(s), opname, old)
                assert t.numpy().tobytes() == want.tobytes(), \
                    (opname, start, fetch)
                if fetch:
                    assert old.numpy().tobytes() == w.tobytes()


def test_rma_acc_refuses_what_it_does_not_take():
    w = torch.zeros(64, dtype=torch.uint8)
    for s, opname in ((torch.ones(2), "MPI_LAND"),
                      (torch.ones(2, dtype=torch.complex64), "MPI_MAX"),
                      (torch.ones(2, dtype=torch.float16), "MPI_SUM"),
                      (torch.ones(2, dtype=torch.int32), "MPI_MAXLOC")):
        with pytest.raises(TypeError):
            rma.rma_acc(w, 0, s, opname)
    with pytest.raises(ValueError):
        rma.rma_acc(w, 60, torch.ones(2), "MPI_SUM")


def test_rma_cas_plain_matches_numpy():
    """Compare by value as numpy's old[0] == cmp[0]: -0.0 equals 0.0,
    NaN equals nothing, complex compares both parts, bool its 0/1
    value; the old bytes come back whatever the outcome."""
    nan = np.nan
    cases = [(np.float32, -0.0, 0.0, 5.0), (np.float32, nan, nan, 5.0),
             (np.float64, 1.5, 1.5, -2.0), (np.float64, 1.5, 2.5, 7.0),
             (np.complex64, 1 + 2j, 1 + 2j, 3j), (np.complex64, 1 + 2j,
                                                   1 - 2j, 5j),
             (np.complex128, complex(nan, 0), complex(nan, 0), 1j),
             (np.bool_, True, True, False), (np.bool_, False, True, True),
             (np.uint64, 2 ** 64 - 1, 2 ** 64 - 1, 3),
             (np.int8, -5, -5, 7), (np.uint16, 5, 6, 1)]
    for dt, wv, cv, nv in cases:
        for start in (0, 3):
            w = np.array([wv], dtype=dt)
            c, n = np.array([cv], dtype=dt), np.array([nv], dtype=dt)
            buf = np.zeros(start + w.nbytes + 2, np.uint8)
            buf[start:start + w.nbytes] = w.view(np.uint8)
            want = buf.copy()
            if w[0] == c[0]:
                want[start:start + w.nbytes] = n.view(np.uint8)
            t = torch.from_numpy(buf.copy())
            old = torch.empty(1, dtype=torch.from_numpy(w).dtype)
            rma.rma_cas(t, start, torch.from_numpy(c), torch.from_numpy(n),
                        old)
            assert t.numpy().tobytes() == want.tobytes(), (dt, wv, cv)
            assert old.numpy().tobytes() == w.tobytes()


def test_rma_plain_calls_are_not_counted():
    before = [f.launches.value for f in (rma.rma_copy, rma.rma_acc,
                                         rma.rma_cas)]
    w = torch.zeros(16, dtype=torch.uint8)
    rma.rma_copy(w, 0, torch.ones(4, dtype=torch.uint8), 0, 4)
    rma.rma_acc(w, 0, torch.ones(2, dtype=torch.int32), "MPI_SUM")
    rma.rma_cas(w, 8, torch.zeros(1, dtype=torch.int64),
                torch.ones(1, dtype=torch.int64),
                torch.empty(1, dtype=torch.int64))
    assert [f.launches.value for f in (rma.rma_copy, rma.rma_acc,
                                       rma.rma_cas)] == before


@pytest.mark.gpu
def test_rma_kernels_match_plain_on_card(cuda_device):
    """K8 at unaligned heads and tails, K9 over every wire dtype and op
    it takes, plain and fetch, aligned and misaligned, and K10's value
    cases, each against its plain version on the card: byte for
    byte."""
    rng = np.random.default_rng(23)
    for n, d_off, s_off in ((1, 0, 0), (17, 1, 3), (65549, 7, 16),
                            (4099, 16, 5)):
        src = torch.from_numpy(rng.integers(0, 256, n + 16,
                                            dtype=np.uint8)).to(cuda_device)
        dst = torch.from_numpy(rng.integers(0, 256, n + 32,
                                            dtype=np.uint8)).to(cuda_device)
        a, b = dst.clone(), dst.clone()
        rma.rma_copy(a, d_off, src, s_off, n)
        rma.rma_copy_plain(b, d_off, src, s_off, n)
        assert torch.equal(a, b)
    for dt in WIRE:
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        for opname in [o for o in RMA_OPS if rma.acc_supported(tdt, o)]:
            for start in (0, dt.itemsize + 1):
                w = _wire_values(rng, 4099, dt)
                s = torch.from_numpy(_wire_values(rng, 4099, dt)).to(
                    cuda_device)
                buf = np.zeros(start + w.nbytes + 5, np.uint8)
                buf[start:start + w.nbytes] = w.view(np.uint8)
                a = torch.from_numpy(buf).to(cuda_device)
                b = a.clone()
                oa = torch.empty(4099, dtype=tdt, device=cuda_device)
                ob = torch.empty_like(oa)
                rma.rma_acc(a, start, s, opname, oa)
                rma.rma_acc_plain(b, start, s, opname, ob)
                assert torch.equal(a, b), (dt, opname, start)
                assert torch.equal(oa.view(torch.uint8),
                                   ob.view(torch.uint8))
    for dt in WIRE:
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        w = torch.from_numpy(_wire_values(rng, 2, dt)).to(cuda_device)
        buf = torch.zeros(3 + 2 * dt.itemsize, dtype=torch.uint8,
                          device=cuda_device)
        buf[3:3 + 2 * dt.itemsize] = w.view(torch.uint8)
        for cmp_elem in (w[0:1], w[1:2]):
            a, b = buf.clone(), buf.clone()
            nv = w[1:2].clone()
            oa = torch.empty(1, dtype=tdt, device=cuda_device)
            ob = torch.empty_like(oa)
            rma.rma_cas(a, 3, cmp_elem.clone(), nv, oa)
            rma.rma_cas_plain(b, 3, cmp_elem.clone(), nv, ob)
            assert torch.equal(a, b) and torch.equal(
                oa.view(torch.uint8), ob.view(torch.uint8)), dt
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# K11 digest (the integrity plane's checksum; its plain version is held
# against the reference's digest in tests/test_torch_integrity.py)
# ---------------------------------------------------------------------------

from ompi_tpu_torch.kernels import digest as k11  # noqa: E402

DIGEST_DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32,
                 np.uint32, np.int64, np.uint64, np.float16, np.float32,
                 np.float64]


def test_digest_refuses_what_the_kernel_does_not_take():
    """bool, bfloat16 and complex, FSUM on ints, INTSUM on floats, an
    unknown code, a strided operand and a table across devices are
    refused on the CPU as on a card; plain calls are not launches."""
    before = k11.digest.launches.value
    for dt, code in ((torch.bool, 1), (torch.bfloat16, 2),
                     (torch.complex64, 2), (torch.int32, 2),
                     (torch.float32, 1), (torch.float32, 9)):
        with pytest.raises(TypeError):
            k11.digest([torch.zeros(4, dtype=dt)], [code])
    with pytest.raises(ValueError):
        k11.digest([torch.zeros(4, 2)[:, 0]], [2])
    with pytest.raises(ValueError):
        k11.digest([torch.zeros(4)], [2, 2])
    with pytest.raises(ValueError):
        k11.digest([torch.zeros(4), torch.zeros(4, device="meta")], [2, 2])
    k11.digest([torch.ones(4)], [2])
    assert k11.digest.launches.value == before


@pytest.mark.gpu
def test_digest_kernel_matches_plain_on_card(cuda_device):
    """K11 against its plain version on the card: every dtype under
    every fold it takes, empty to 2**17 + 3 elements, one table of 32
    mixed operands in one launch, and a table beyond MAX_OPS (two
    launches).  INTSUM, MAX and MIN exact; FSUM within 1e-12 relative
    and bit-identical across two launches."""
    rng = np.random.default_rng(17)
    xs, codes = [], []
    for dt in DIGEST_DTYPES:
        fl = np.dtype(dt).kind == "f"
        for n in (0, 1, 2, 1000, (1 << 17) + 3):
            if fl:
                a = (rng.standard_normal(n) * 100).astype(dt)
                if n > 8:
                    a[3] = np.nan if n % 2 else -0.0
            else:
                info = np.iinfo(dt)
                a = rng.integers(info.min, info.max, size=n, dtype=dt,
                                 endpoint=True)
            for code in ((2, 3, 4) if fl else (1, 3, 4)):
                xs.append(convert.to_torch(a, cuda_device))
                codes.append(code)
    for lo in range(0, len(xs), 32):
        part = slice(lo, lo + 32)
        launches = k11.digest.launches.value
        got = k11.digest(xs[part], codes[part])
        assert k11.digest.launches.value == launches + 1
        again = k11.digest(xs[part], codes[part])
        want = k11.digest_plain(xs[part], codes[part])
        assert torch.equal(got, again)
        for t, c, g, w in zip(xs[part], codes[part], got.tolist(),
                              want.tolist()):
            gv, wv = (k11.decode(g, c, t.dtype), k11.decode(w, c, t.dtype))
            if c == 2 and wv == wv and abs(wv) != float("inf"):
                assert abs(gv - wv) <= 1e-12 * max(abs(gv), abs(wv))
            else:
                assert gv == wv or (gv != gv and wv != wv), (t.dtype, c)
    launches = k11.digest.launches.value
    big = k11.digest(xs[:k11.MAX_OPS + 5], codes[:k11.MAX_OPS + 5])
    assert k11.digest.launches.value == launches + 2
    assert torch.equal(big, torch.cat([
        k11.digest(xs[:k11.MAX_OPS], codes[:k11.MAX_OPS]),
        k11.digest(xs[k11.MAX_OPS:k11.MAX_OPS + 5],
                   codes[k11.MAX_OPS:k11.MAX_OPS + 5])]))
    torch.cuda.synchronize()


# -- K2 peer null sources and K12 driver_step --------------------------------

def test_peer_copy_plain_null_sources_zero_fill():
    """A None source is a PROC_NULL neighbour: its block is zeros (a
    2*3-slot table with PROC_NULL at either end), the other blocks are
    copies; no size check applies to a null source."""
    xs = [torch.arange(6, dtype=torch.int32) + 10 * j for j in range(4)]
    srcs = [None, xs[1], xs[2], xs[3], xs[0], None]
    out = torch.full((36,), -7, dtype=torch.int32)
    got = stacked.peer_copy(srcs, out, 6)
    assert got is out
    want = torch.cat([torch.zeros(6, dtype=torch.int32)] + xs[1:] + [
        xs[0], torch.zeros(6, dtype=torch.int32)])
    assert torch.equal(out, want)
    plain = stacked.peer_copy_plain(srcs, torch.full((36,), -7,
                                                     dtype=torch.int32), 6)
    assert torch.equal(plain, want)
    # all-null, clipped by the limit: only what the limit admits is zeroed
    out = torch.full((12,), 5.0)
    stacked.peer_copy([None, None], out, 6, limit=9)
    assert out.tolist() == [0.0] * 9 + [5.0] * 3
    # a real source is still checked; a null one never is
    with pytest.raises(ValueError):
        stacked.peer_copy([None, torch.ones(2)], torch.empty(12), 6)


def test_peer_copy_null_sources_do_not_count_on_the_cpu():
    before = stacked.peer_copy.launches.value
    stacked.peer_copy([None, torch.ones(4)], torch.empty(8), 4)
    assert stacked.peer_copy.launches.value == before


def _k12_input(rng, r, n, dt):
    if dt == np.bool_:
        return rng.integers(0, 2, (r, n)).astype(np.bool_)
    if dt.kind == "c":
        return (rng.standard_normal((r, n))
                + 1j * rng.standard_normal((r, n))).astype(dt)
    if _is_float(dt):
        return rng.standard_normal((r, n)).astype(np.float32).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(max(info.min, -2 ** 62), min(info.max, 2 ** 62),
                        (r, n)).astype(dt)


@pytest.mark.parametrize("dt", DTYPES, ids=str)
def test_driver_step_plain_against_numpy(dt):
    """K12's plain version on the CPU: rs is K1's SUM fold of the rows
    (stacked_reduce_plain, the same bytes), out adds the alltoall's
    block transpose to it — against numpy for the exact types."""
    from ompi_tpu_torch.kernels import entry as k12
    rng = np.random.default_rng(12)
    for r, n in ((2, 8), (8, 1024), (8, 8 * 37), (3, 9)):
        a = _k12_input(rng, r, n, dt)
        x = convert.to_torch(a, "cpu")
        out, rs = k12.driver_step(x)
        assert out.shape == (r, n) and rs.shape == (r, n // r)
        assert out.dtype == x.dtype and rs.dtype == x.dtype
        red = stacked.stacked_reduce_plain(list(x.unbind(0)), "MPI_SUM")[0]
        assert torch.equal(rs.reshape(-1).view(torch.uint8),
                           red.view(torch.uint8))
        if dt.kind in "iu" and dt.itemsize >= 4 or dt == np.bool_:
            m = n // r
            with np.errstate(over="ignore"):
                s = a.sum(0, dtype=dt) if dt != np.bool_ else a.any(0)
                a2a = a.reshape(r, r, m).transpose(1, 0, 2).reshape(r, n)
                want = (s[None, :] + a2a) if dt != np.bool_ \
                    else (s[None, :] | a2a)
            assert convert.to_numpy(out).tobytes() == \
                want.astype(dt).tobytes()


def test_driver_step_refusals():
    """N % R != 0, R over K1's cap, a non-contiguous or non-2-D x and a
    dtype without SUM are refused on the CPU as on the card."""
    from ompi_tpu_torch.kernels import entry as k12
    before = k12.driver_step.launches.value
    for bad in (torch.ones(8, 1020), torch.ones(129, 129),
                torch.ones(16, 8).t(), torch.ones(8), torch.ones(2, 2, 2)):
        with pytest.raises(ValueError):
            k12.driver_step(bad)
        with pytest.raises(ValueError):
            k12.driver_step_plain(bad)
    with pytest.raises(ValueError):
        k12.driver_step(torch.ones(8, 8, device="meta"))
    out, rs = k12.driver_step(torch.ones(128, 128))
    assert out.shape == (128, 128) and rs.shape == (128, 1)
    assert float(rs[0, 0]) == 128.0 and float(out[0, 0]) == 129.0
    assert k12.driver_step.launches.value == before


@pytest.mark.gpu
def test_driver_step_kernel_matches_plain_on_card(cuda_device):
    """K12 against its plain version on the card, every dtype K1's SUM
    takes, R in {2, 8}, vector and scalar widths: exact (the same fold
    in the same order and accumulation type, one rounded add)."""
    from ompi_tpu_torch.kernels import entry as k12
    rng = np.random.default_rng(13)
    for dt in DTYPES:
        for r, n in ((2, 8), (8, 1024), (8, 8 * 37), (8, 1 << 16)):
            x = convert.to_torch(_k12_input(rng, r, n, dt), cuda_device)
            launches = k12.driver_step.launches.value
            got = k12.driver_step(x)
            assert k12.driver_step.launches.value == launches + 1
            want = k12.driver_step_plain(x)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                if dt.kind == "f" or dt == BF16 or dt.kind == "c":
                    assert torch.equal(g, w), (dt, r, n)
                else:
                    assert torch.equal(g.view(torch.uint8),
                                       w.view(torch.uint8)), (dt, r, n)
    with pytest.raises(ValueError):
        k12.driver_step(torch.ones(8, 1020, device=cuda_device))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_peer_copy_null_sources_match_plain_on_card(cuda_device):
    """K2 peer with None sources on the card: zeros in the null blocks
    in the same launch, exact against the plain version."""
    rng = np.random.default_rng(14)
    for dt in (np.float32, np.int8, np.float64):
        xs = [convert.to_torch(rng.standard_normal(1031).astype(dt),
                               cuda_device) for _ in range(4)]
        srcs = [None, xs[0], xs[1], xs[2], xs[3], None]
        a = torch.full((6 * 1031,), 3, dtype=xs[0].dtype, device=cuda_device)
        b = a.clone()
        launches = stacked.peer_copy.launches.value
        stacked.peer_copy(srcs, a, 1031)
        assert stacked.peer_copy.launches.value == launches + 1
        stacked.peer_copy_plain(srcs, b, 1031)
        assert torch.equal(a, b)
        assert not a[:1031].any() and not a[-1031:].any()
    torch.cuda.synchronize()
