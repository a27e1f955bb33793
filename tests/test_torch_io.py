"""MPI-IO through the port (ompi_tpu_torch/io: views, individual,
shared, ordered and two-phase collective IO, the sharedfp hint), with
the reference beside it.

The analogs of tests/test_io.py.  Every rank program is written once
against a package namespace and runs through both packages' ``File``
on ``run_ranks`` thread worlds (numpy buffers on the host path, as in
the reference), each into its own file; the results must be equal and
the two files byte for byte identical.  The pure FileView cases
compare the two packages' segment maps.  Inputs are seeded numpy
arrays where the reference's test uses fixed ramps.  Tolerance: bytes.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest

from ompi_tpu import io as ref_io
from ompi_tpu.datatype import engine as ref_dt
from ompi_tpu.io.view import FileView as RefFileView
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import io as port_io
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.io.view import FileView
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

SEED = 20261018
REF = SimpleNamespace(name="ref", io=ref_io, dt=ref_dt, view=RefFileView,
                      run_ranks=ref_run_ranks, registry=ref_registry)
PORT = SimpleNamespace(name="port", io=port_io, dt=port_dt, view=FileView,
                       run_ranks=port_run_ranks, registry=port_registry)


def _rw(P):
    return P.io.MODE_CREATE | P.io.MODE_RDWR


def _both(tmp_path, name, make, n, same_file=True):
    """Run ``make(P, path)``'s rank function on ``n`` ranks of each
    package, each into its own file; returns (ref results, port
    results, path of the port's file).  The two results must be equal
    and, with ``same_file``, the two files byte for byte identical."""
    out = {}
    for P in (REF, PORT):
        path = str(tmp_path / f"{P.name}-{name}")
        out[P.name] = (P.run_ranks(n, make(P, path), timeout=120), path)
    (ref, rpath), (port, ppath) = out["ref"], out["port"]
    assert _plain(port) == _plain(ref)
    if same_file:
        assert os.path.exists(ppath) == os.path.exists(rpath)
        if os.path.exists(ppath):
            with open(ppath, "rb") as a, open(rpath, "rb") as b:
                assert a.read() == b.read()
    return ref, port, ppath


def _plain(x):
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _vals(n, scale=100.0, rank=0):
    rng = np.random.default_rng(SEED + rank)
    return np.round(rng.uniform(-scale, scale, n), 3)


# -- FileView mapping (pure) ------------------------------------------------

def _maps(build, calls):
    """The two packages' segment maps of ``calls`` over views built by
    ``build(P)``."""
    got = []
    for P in (REF, PORT):
        v = build(P)
        got.append([v.map_bytes(*c) for c in calls])
    assert got[0] == got[1]
    return got[1]


def test_view_default_is_byte_stream():
    assert _maps(lambda P: P.view(), [(10, 4)]) == [[(10, 4)]]


def test_view_disp_and_etype_units():
    assert _maps(lambda P: P.view(disp=100, etype=P.dt.DOUBLE),
                 [(2, 24)]) == [[(116, 24)]]


def test_view_strided_filetype():
    def build(P):
        v = P.view(0, P.dt.DOUBLE, P.dt.resized(P.dt.DOUBLE, 0, 16))
        assert v.tile_bytes == 8 and v.tile_extent == 16
        return v
    assert _maps(build, [(0, 8), (1, 8), (0, 24)]) == [
        [(0, 8)], [(16, 8)], [(0, 8), (16, 8), (32, 8)]]


def test_view_block_cyclic():
    def ft(P):
        return P.dt.resized(P.dt.contiguous(2, P.dt.DOUBLE), 0, 32)
    assert _maps(lambda P: P.view(0, P.dt.DOUBLE, ft(P)),
                 [(0, 32), (1, 16)]) == [[(0, 16), (32, 16)],
                                         [(8, 8), (32, 8)]]
    assert _maps(lambda P: P.view(16, P.dt.DOUBLE, ft(P)),
                 [(0, 32)]) == [[(16, 16), (48, 16)]]


def test_view_rejects_bad_etype_multiple():
    for P in (REF, PORT):
        with pytest.raises(ValueError):
            P.view(0, P.dt.DOUBLE, P.dt.contiguous(3, P.dt.INT32_T))


def test_view_resized_smaller_extent_than_true_ub():
    def build(P):
        v = P.view(0, P.dt.DOUBLE, P.dt.resized(
            P.dt.indexed_block(1, [1], P.dt.DOUBLE), 0, 8))
        assert v.tile_extent == 8
        return v
    assert _maps(build, [(0, 8), (1, 8)]) == [[(8, 8)], [(16, 8)]]


def test_view_rejects_truly_overlapping_tiles():
    for P in (REF, PORT):
        with pytest.raises(ValueError):
            P.view(0, P.dt.DOUBLE, P.dt.resized(
                P.dt.contiguous(2, P.dt.DOUBLE), 0, 8))


def test_view_legal_interleaved_tiles():
    assert _maps(lambda P: P.view(0, P.dt.INT32_T, P.dt.resized(
        P.dt.indexed_block(1, [0, 3], P.dt.INT32_T), 0, 8)),
        [(0, 16)]) == [[(0, 4), (12, 4), (8, 4), (20, 4)]]


# -- individual IO ----------------------------------------------------------

def test_write_read_at(tmp_path):
    n = 16

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.write_at(comm.rank * n * 8, _vals(n, rank=comm.rank))
            f.sync()
            comm.Barrier()
            got = np.empty(n, dtype=np.float64)
            f.read_at(((comm.rank + 1) % comm.size) * n * 8, got)
            f.close()
            return got
        return fn

    _, port, _ = _both(tmp_path, "wr.bin", make, 3)
    for rank, got in enumerate(port):
        np.testing.assert_array_equal(got, _vals(n, rank=(rank + 1) % 3))


def test_individual_pointer_seek_tell(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.DOUBLE)
            if comm.rank == 0:
                f.write(_vals(3))
                assert f.get_position() == 3
                f.seek(1)
                out = np.zeros(2)
                f.read(out)
                assert f.get_position() == 3
                f.seek(-1, P.io.SEEK_CUR)
                assert f.get_position() == 2
                f.seek(0, P.io.SEEK_END)
                end = f.get_position()
                f.close()
                return (out.tolist(), end)
            f.close()
            return None
        return fn

    _, port, _ = _both(tmp_path, "seek.bin", make, 2)
    assert port[0] == (_vals(3)[1:].tolist(), 3)


def test_eof_read_zero_fills(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            if comm.rank == 0:
                f.write_at(0, np.array([7.0]))
            f.sync()
            comm.Barrier()
            out = np.full(4, -1.0)
            f.read_at(0, out)
            f.close()
            return out.tolist()
        return fn

    _, port, _ = _both(tmp_path, "eof.bin", make, 2)
    assert port == [[7.0, 0.0, 0.0, 0.0]] * 2


def test_file_size_ops_and_delete(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P) | P.io.MODE_DELETE_ON_CLOSE)
            if comm.rank == 0:
                f.set_size(1024)
            f.sync()
            comm.Barrier()
            s = f.get_size()
            f.close()
            return s
        return fn

    _, port, path = _both(tmp_path, "size.bin", make, 2)
    assert port == [1024, 1024]
    assert not os.path.exists(path)


def test_collective_open_failure_raises_everywhere(tmp_path):
    def make(P, path):
        bad = os.path.join(path, "nonexistent", "x.bin")

        def fn(comm):
            try:
                P.io.open(comm, bad, P.io.MODE_RDONLY)
                return "no-error"
            except OSError:
                return "ok"
        return fn

    _, port, _ = _both(tmp_path, "openfail", make, 2)
    assert port == ["ok", "ok"]


def test_iwrite_iread_requests(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            if comm.rank == 0:
                f.iwrite_at(0, np.arange(8, dtype=np.int64) * 7).wait()
            f.sync()
            comm.Barrier()
            out = np.zeros(8, dtype=np.int64)
            st = f.iread_at(0, out).wait()
            f.close()
            return (out.tolist(), st.count)
        return fn

    _, port, _ = _both(tmp_path, "nb.bin", make, 2)
    assert port == [([7 * i for i in range(8)], 64)] * 2


def test_write_all_wronly_no_rmw_crash(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, P.io.MODE_CREATE | P.io.MODE_WRONLY)
            f.set_view(0, P.dt.DOUBLE)
            f.write_at_all(comm.rank * 8, np.full(4, comm.rank + 1.0))
            f.close()
            return "ok"
        return fn

    _, port, path = _both(tmp_path, "wronly.bin", make, 2)
    assert port == ["ok", "ok"]
    raw = np.fromfile(path, dtype=np.float64)
    assert list(raw[:4]) == [1.0] * 4 and list(raw[8:12]) == [2.0] * 4


def test_append_mode_starts_at_eof(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.DOUBLE)
            if comm.rank == 0:
                f.write_at(0, np.full(4, 1.0))
            f.close()
            f = P.io.open(comm, path, P.io.MODE_RDWR | P.io.MODE_APPEND)
            f.set_view(0, P.dt.DOUBLE)
            f.seek(0, P.io.SEEK_END)
            if comm.rank == 0:
                f.write_at(4, np.full(2, 2.0))
            f.sync()
            comm.Barrier()
            out = np.zeros(6)
            f.read_at(0, out)
            f.close()
            return out.tolist()
        return fn

    _, port, _ = _both(tmp_path, "append.bin", make, 2)
    assert port[0] == [1.0] * 4 + [2.0] * 2


def test_read_count_reports_actual_at_eof(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            if comm.rank == 0:
                f.write_at(0, np.full(1, 3.0))
            f.sync()
            comm.Barrier()
            st = f.read_at(0, np.zeros(4))
            f.close()
            return st.count
        return fn

    _, port, _ = _both(tmp_path, "count.bin", make, 2)
    assert port == [8, 8]


def test_seek_invalid_leaves_position(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.seek(2)
            try:
                f.seek(-5, P.io.SEEK_CUR)
                out = "no-error"
            except ValueError:
                out = f.get_position()
            f.close()
            return out
        return fn

    _, port, _ = _both(tmp_path, "seekerr.bin", make, 2)
    assert port == [2, 2]


# -- views over real files --------------------------------------------------

def test_interleaved_views_write_then_read_whole(tmp_path):
    n_each = 4

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            ft = P.dt.resized(P.dt.contiguous(n_each, P.dt.DOUBLE), 0,
                              n_each * comm.size * 8)
            f.set_view(comm.rank * n_each * 8, P.dt.DOUBLE, ft)
            f.write(_vals(2 * n_each, rank=comm.rank))
            f.sync()
            comm.Barrier()
            f.set_view(0, P.dt.DOUBLE)
            whole = np.zeros(2 * n_each * comm.size)
            f.read_at(0, whole)
            f.close()
            return whole
        return fn

    _, port, _ = _both(tmp_path, "interleave.bin", make, 3)
    expect = np.concatenate([_vals(2 * n_each, rank=r)[t * n_each:
                                                       (t + 1) * n_each]
                             for t in range(2) for r in range(3)])
    np.testing.assert_array_equal(port[0], expect)


# -- shared / ordered (the shared pointer: an osc window) -------------------

def test_write_shared_disjoint_records(tmp_path):
    rec = 8

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            for _ in range(2):
                f.write_shared(np.full(rec, comm.rank * 1.0))
            f.sync()
            comm.Barrier()
            out = np.full(rec * 2 * comm.size, -1.0)
            f.read_at(0, out)
            pos = f.get_position_shared()
            f.close()
            recs = sorted(tuple(out[i * rec:(i + 1) * rec])
                          for i in range(2 * comm.size))
            return (recs, pos)
        return fn

    # the records' order in the file is the ranks' arrival order: the
    # files differ between runs, the sorted records do not
    _, port, _ = _both(tmp_path, "shared.bin", make, 3, same_file=False)
    recs, pos = port[0]
    assert [r[0] for r in recs] == [0.0, 0.0, 1.0, 1.0, 2.0, 2.0]
    assert all(len(set(r)) == 1 for r in recs)
    assert pos == 6 * rec * 8 and port[1][1] == port[2][1] == pos


def test_write_ordered_rank_order(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.DOUBLE)
            f.write_ordered(np.full(comm.rank + 1, comm.rank * 1.0))
            f.sync()
            comm.Barrier()
            out = np.full(6, -1.0)
            f.read_at(0, out)
            f.close()
            return out.tolist()
        return fn

    _, port, _ = _both(tmp_path, "ordered.bin", make, 3)
    assert port[0] == [0.0, 1.0, 1.0, 2.0, 2.0, 2.0]


def test_seek_shared_resets(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.write_shared(np.zeros(4, dtype=np.uint8))
            comm.Barrier()
            f.seek_shared(0)
            p = f.get_position_shared()
            f.close()
            return p
        return fn

    _, port, _ = _both(tmp_path, "seeksh.bin", make, 2)
    assert port == [0, 0]


def test_sharedfp_hint_disables_shared_pointers(tmp_path):
    """info {'sharedfp': 'false'} skips the shared-pointer window (the
    checkpoint engine's open mode); explicit-offset and collective IO
    still work, shared-pointer operations raise."""
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P), info={"sharedfp": "false"})
            assert f._sp_win is None and f._sp_comm is None
            data = _vals(4, rank=comm.rank)
            f.write_at(comm.rank * 32, data)
            f.sync()
            comm.Barrier()
            back = np.zeros(4, dtype=np.float64)
            f.read_at_all(comm.rank * 32, back)
            np.testing.assert_array_equal(back, data)
            with pytest.raises(RuntimeError, match="sharedfp"):
                f.write_shared(data)
            with pytest.raises(RuntimeError, match="sharedfp"):
                f.get_position_shared()
            f.close()
            return True
        return fn

    _, port, _ = _both(tmp_path, "nosp.bin", make, 2)
    assert port == [True, True]


def test_sharedfp_default_still_enabled(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            assert f._sp_win is not None
            f.write_shared(np.full(2, float(comm.rank + 1)))
            comm.Barrier()
            pos = f.get_position_shared()
            f.close()
            return pos
        return fn

    _, port, _ = _both(tmp_path, "sp.bin", make, 2, same_file=False)
    assert port == [32, 32]


# -- collective two-phase ---------------------------------------------------

class knobs:
    """Set MCA knobs in both registries; restore on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (ref_registry, port_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)


@pytest.mark.parametrize("naggs", [0, 1, 2])
def test_write_at_all_contiguous_blocks(tmp_path, naggs):
    n = 32

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.write_at_all(comm.rank * n * 8, _vals(n, 1000.0, comm.rank))
            f.sync()
            comm.Barrier()
            out = np.zeros(n * comm.size, dtype=np.float64)
            f.read_at(0, out)
            f.close()
            return out
        return fn

    with knobs({"io_fcoll_num_aggregators": naggs}):
        _, port, _ = _both(tmp_path, f"wall{naggs}.bin", make, 3)
    np.testing.assert_array_equal(
        port[0], np.concatenate([_vals(n, 1000.0, r) for r in range(3)]))


def test_write_at_all_interleaved_views(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            ft = P.dt.resized(P.dt.contiguous(2, P.dt.DOUBLE), 0,
                              2 * comm.size * 8)
            f.set_view(comm.rank * 16, P.dt.DOUBLE, ft)
            f.write_at_all(0, _vals(6, rank=comm.rank))
            f.sync()
            comm.Barrier()
            f.set_view(0, P.dt.DOUBLE)
            whole = np.zeros(6 * comm.size)
            f.read_at(0, whole)
            f.close()
            return whole
        return fn

    _, port, _ = _both(tmp_path, "wallview.bin", make, 4)
    expect = np.concatenate([_vals(6, rank=r)[2 * t:2 * t + 2]
                             for t in range(3) for r in range(4)])
    np.testing.assert_array_equal(port[0], expect)


def test_read_at_all_roundtrip(tmp_path):
    n = 16

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            if comm.rank == 0:
                f.write_at(0, _vals(n * comm.size))
            f.sync()
            comm.Barrier()
            mine = np.zeros(n, dtype=np.float64)
            f.read_at_all(comm.rank * n * 8, mine)
            f.close()
            return mine
        return fn

    _, port, _ = _both(tmp_path, "rall.bin", make, 4)
    for rank, got in enumerate(port):
        np.testing.assert_array_equal(
            got, _vals(n * 4)[rank * n:(rank + 1) * n])


def test_write_all_gap_preserves_existing(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.DOUBLE)
            if comm.rank == 0:
                f.write_at(0, np.full(64, 9.0))
            f.sync()
            comm.Barrier()
            f.write_at_all(comm.rank * 24, np.full(8, comm.rank + 1.0))
            f.sync()
            comm.Barrier()
            out = np.zeros(32)
            f.read_at(0, out)
            f.close()
            return out.tolist()
        return fn

    _, port, _ = _both(tmp_path, "gap.bin", make, 2)
    out = port[0]
    assert out[:8] == [1.0] * 8
    assert out[8:24] == [9.0] * 16
    assert out[24:32] == [2.0] * 8


def test_read_all_sparse_views(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            if comm.rank == 0:
                f.write_at(0, _vals(32))
            f.sync()
            comm.Barrier()
            ft = P.dt.resized(P.dt.DOUBLE, 0, comm.size * 8)
            f.set_view(comm.rank * 8, P.dt.DOUBLE, ft)
            mine = np.zeros(32 // comm.size)
            f.read_at_all(0, mine)
            f.close()
            return mine
        return fn

    _, port, _ = _both(tmp_path, "rsparse.bin", make, 4)
    for rank, got in enumerate(port):
        np.testing.assert_array_equal(got, _vals(32)[rank::4])


def test_write_all_sparse_far_apart_offsets(tmp_path):
    """1 double at offset 0 and 1 double 256 GiB away: aggregation
    allocates covered intervals only.  The two sparse files are
    compared by size and by the bytes at both ends."""
    far = 1 << 38

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.DOUBLE)
            f.write_at_all((comm.rank * far) // 8,
                           np.full(1, comm.rank + 1.0))
            f.sync()
            comm.Barrier()
            out0, out1 = np.zeros(1), np.zeros(1)
            f.read_at(0, out0)
            f.read_at(far // 8, out1)
            size = f.get_size()
            f.close()
            return (out0[0], out1[0], size)
        return fn

    _, port, _ = _both(tmp_path, "sparse_far.bin", make, 2,
                       same_file=False)
    assert port == [(1.0, 2.0, far + 8)] * 2


def test_read_all_true_eof_counts(tmp_path):
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.DOUBLE)
            if comm.rank == 0:
                f.write_at(0, _vals(6))
            f.sync()
            comm.Barrier()
            st = f.read_at_all(comm.rank * 4, np.zeros(4))
            f.close()
            return st.count
        return fn

    _, port, _ = _both(tmp_path, "eofcnt.bin", make, 2)
    assert port == [32, 16]


# -- the port's own: the split collectives and the datarep hook ------------

def test_split_collectives_and_one_active_rule(tmp_path):
    """``write_all_begin``/``_end`` and ``read_at_all_begin``/``_end``
    run the collective and hand back its status; a second begin while
    one is active raises, in both packages."""
    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(comm.rank * 32, P.dt.DOUBLE, P.dt.resized(
                P.dt.contiguous(4, P.dt.DOUBLE), 0, 32 * comm.size))
            f.write_all_begin(_vals(8, rank=comm.rank))
            with pytest.raises(RuntimeError):
                f.read_all_begin(np.zeros(8))
            w = f.write_all_end().count
            back = np.zeros(8)
            f.read_at_all_begin(0, back)
            r = f.read_at_all_end().count
            f.close()
            return (w, r, back)
        return fn

    _, port, _ = _both(tmp_path, "split.bin", make, 3)
    for rank, (w, r, back) in enumerate(port):
        assert w == r == 64
        np.testing.assert_array_equal(back, _vals(8, rank=rank))


def test_register_datarep_converts_on_write_and_read(tmp_path):
    """A user data representation's write conversion lands in the
    file and its read conversion undoes it; a name taken twice raises
    (MPI_ERR_DUP_DATAREP)."""
    name = f"xor55-{os.getpid()}-{tmp_path.name}"  # registered once

    def conv(data, dt, count, extra):
        return bytes(b ^ extra for b in data)

    for P in (REF, PORT):
        P.io.file.register_datarep(name, conv, conv, None, 0x55)
        with pytest.raises(ValueError):
            P.io.file.register_datarep(name)

    def make(P, path):
        def fn(comm):
            f = P.io.open(comm, path, _rw(P))
            f.set_view(0, P.dt.BYTE, None, name)
            data = np.arange(16, dtype=np.uint8) + 16 * comm.rank
            f.write_at(16 * comm.rank, data)
            f.sync()
            comm.Barrier()
            back = np.zeros(16 * comm.size, dtype=np.uint8)
            f.read_at(0, back)
            f.close()
            return back
        return fn

    _, port, path = _both(tmp_path, "datarep.bin", make, 2)
    np.testing.assert_array_equal(port[0], np.arange(32, dtype=np.uint8))
    raw = np.fromfile(path, dtype=np.uint8)
    np.testing.assert_array_equal(raw, np.arange(32, dtype=np.uint8) ^ 0x55)
