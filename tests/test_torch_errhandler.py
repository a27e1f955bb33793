"""Error handlers, attribute keyvals and Info through both packages:
ompi_tpu.errhandler / attrs / info and their ports — error classes
and strings, dispatch through a communicator's handler (the
communicator's ``_guard`` over the 28 guarded operations), the
``mpi_errhandler_world_default`` variable installed on the
predefined communicators at init, inheritance by dup, split,
create_group, create, intercomms and their merge, the predefined
world attributes, copy and delete callbacks (dup copies, free
deletes), deferred keyval frees, Info and its use by comms and files,
and the flat bindings over them.

The analogs of tests/test_errhandler.py's 21 tests.  Each test body
runs once through each package (ids ``port`` and ``ref``), on host
buffers, and both are held to the same expected values.

Tolerance: exact — error classes, strings, attribute values, the
order of callback calls.
"""

import importlib
import types

import numpy as np
import pytest


def _pkg(name):
    def imp(sub):
        return importlib.import_module(f"{name}.{sub}")

    eh = imp("errhandler")
    info = imp("info")
    return types.SimpleNamespace(
        name=name, imp=imp, eh=eh, attrs=imp("attrs"), mpi=imp("mpi"),
        Info=info.Info, info_env=info.info_env,
        registry=imp("mca.params").registry,
        run_ranks=imp("testing").run_ranks)


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return _pkg("ompi_tpu_torch" if request.param == "port"
                else "ompi_tpu")


# ---- error classes / dispatch --------------------------------------

def test_error_classify_and_string(pkg):
    eh = pkg.eh
    assert eh.classify(ValueError("x (MPI_ERR_RANK)")) == eh.ERR_RANK
    assert eh.classify(FileNotFoundError("f")) == eh.ERR_NO_SUCH_FILE
    assert eh.classify(eh.MPIException(eh.ERR_TRUNCATE)) \
        == eh.ERR_TRUNCATE
    assert eh.classify(KeyError("k")) == eh.ERR_OTHER
    assert eh.error_string(eh.ERR_RANK) == "MPI_ERR_RANK"
    assert (eh.ERR_RANK, eh.ERR_LASTCODE) == (6, 93)


def test_errors_return_reraises(pkg):
    eh = pkg.eh

    def fn(comm):
        assert comm.Get_errhandler() is eh.ERRORS_RETURN
        with pytest.raises(ValueError):
            comm.Send(np.zeros(1), dest=99)  # invalid rank
        return True

    assert pkg.run_ranks(2, fn) == [True, True]


def test_user_handler_invoked_before_raise(pkg):
    eh = pkg.eh

    def fn(comm):
        seen = []
        comm.Set_errhandler(eh.Errhandler(
            lambda c, code: seen.append((c.name, code))))
        with pytest.raises(ValueError):
            comm.Send(np.zeros(1), dest=99)
        # a root out of range fails inside the collective on every
        # member (IndexError on one, the meeting's RuntimeError on the
        # others): MPI_ERR_OTHER everywhere, one call a rank
        with pytest.raises((IndexError, RuntimeError)):
            comm.Bcast(np.zeros(1), root=comm.size)
        # dup carries the handler over
        d = comm.dup()
        return seen, d.Get_errhandler() is comm.Get_errhandler()

    want = [("MPI_COMM_WORLD", pkg.eh.ERR_RANK),
            ("MPI_COMM_WORLD", pkg.eh.ERR_OTHER)]
    assert pkg.run_ranks(2, fn) == [(want, True)] * 2


def test_errors_are_fatal_aborts(pkg):
    """FATAL routes through rte.abort → SystemExit in thread worlds."""
    def fn(comm):
        comm.Set_errhandler(pkg.eh.ERRORS_ARE_FATAL)
        try:
            comm.Send(np.zeros(1), dest=99)
        except SystemExit:
            return "aborted"
        return "no-abort"

    assert pkg.run_ranks(1, fn) == ["aborted"]


def test_call_errhandler_explicit(pkg):
    eh = pkg.eh

    def fn(comm):
        hits = []
        comm.Set_errhandler(eh.Errhandler(lambda c, code: hits.append(code)))
        with pytest.raises(eh.MPIException):
            comm.Call_errhandler(eh.ERR_IO)
        return hits

    assert pkg.run_ranks(1, fn) == [[pkg.eh.ERR_IO]]


# ---- attributes -----------------------------------------------------

def test_predefined_world_attrs(pkg):
    attrs = pkg.attrs

    def fn(comm):
        return [comm.Get_attr(k) for k in (attrs.TAG_UB, attrs.UNIVERSE_SIZE,
                                           attrs.WTIME_IS_GLOBAL,
                                           attrs.APPNUM, attrs.HOST)]

    want = [(True, 2**31 - 1), (True, 2), (True, False), (True, 0),
            (False, None)]
    assert pkg.run_ranks(2, fn) == [want, want]


def test_keyval_copy_delete_callbacks(pkg):
    attrs = pkg.attrs

    def fn(comm):
        log = []
        kv = attrs.create_keyval(
            copy_fn=lambda obj, k, extra, v: log.append(("copy", v, extra))
            or v * 2,
            delete_fn=lambda obj, k, v, extra: log.append(("del", v)),
            extra_state="xs")
        comm.Set_attr(kv, 21)
        got = [comm.Get_attr(kv)]
        d = comm.dup()
        got.append(d.Get_attr(kv))  # copy callback ran
        comm.Set_attr(kv, 5)  # overwrite deletes the old value
        d.free()  # delete_all on free
        comm.Delete_attr(kv)
        got.append(comm.Get_attr(kv))
        attrs.free_keyval(kv)
        return got, log

    want = ([(True, 21), (True, 42), (False, None)],
            [("copy", 21, "xs"), ("del", 21), ("del", 42), ("del", 5)])
    assert pkg.run_ranks(2, fn) == [want, want]


def test_null_copy_fn_not_propagated(pkg):
    def fn(comm):
        kv = pkg.attrs.create_keyval()  # MPI_NULL_COPY_FN
        comm.Set_attr(kv, "private")
        return comm.dup().Get_attr(kv)

    assert pkg.run_ranks(1, fn) == [(False, None)]


def test_invalid_keyval_rejected(pkg):
    def fn(comm):
        with pytest.raises(ValueError, match="MPI_ERR_KEYVAL"):
            comm.Set_attr(424242, 1)
        return True

    assert pkg.run_ranks(1, fn) == [True]


# ---- info -----------------------------------------------------------

def test_info_basic(pkg):
    inf = pkg.Info()
    inf.set("cb_buffer_size", "1048576")
    inf.set("striping_factor", "4")
    assert inf.get("cb_buffer_size") == (True, "1048576")
    assert inf.get("nope") == (False, None)
    assert inf.nkeys() == 2
    assert inf.nthkey(0) == "cb_buffer_size"
    d = inf.dup()
    inf.delete("striping_factor")
    assert inf.nkeys() == 1 and d.nkeys() == 2
    with pytest.raises(KeyError):
        inf.delete("striping_factor")


def test_info_limits(pkg):
    inf = pkg.Info()
    with pytest.raises(ValueError):
        inf.set("", "v")
    with pytest.raises(ValueError):
        inf.set("k" * 300, "v")


def test_info_env(pkg):
    inf = pkg.info_env()
    assert inf.get("thread_level")[0]
    assert inf.get("host")[0]


def test_comm_set_get_info(pkg):
    def fn(comm):
        empty = comm.Get_info().nkeys()
        inf = pkg.Info()
        inf.set("hint", "on")
        comm.Set_info(inf)
        got = comm.Get_info()
        got.set("other", "x")  # a copy: the comm's hints stay
        d = comm.dup()
        return (empty, comm.Get_info().get("hint"),
                comm.Get_info().nkeys(), d.Get_info().get("hint"))

    assert pkg.run_ranks(1, fn) == [(0, (True, "on"), 1, (True, "on"))]


def test_info_threads_into_file_open(pkg, tmp_path):
    iomod = pkg.imp("io.file")

    def fn(comm):
        inf = pkg.Info()
        inf.set("cb_buffer_size", "65536")
        f = iomod.open(comm, str(tmp_path / f"{pkg.name}.bin"),
                       iomod.MODE_CREATE | iomod.MODE_RDWR, info=inf)
        got = (f.info["cb_buffer_size"],
               f.Get_errhandler() is pkg.eh.ERRORS_RETURN)
        f.close()
        return got

    assert pkg.run_ranks(2, fn) == [("65536", True)] * 2


# ---- flat bindings --------------------------------------------------

def test_flat_bindings_surface(pkg):
    mpi = pkg.mpi
    assert mpi.MPI_Error_string(mpi.MPI_ERR_RANK) == "MPI_ERR_RANK"
    assert mpi.MPI_Error_class(mpi.MPI_ERR_IO) == mpi.MPI_ERR_IO
    inf = mpi.MPI_Info_create()
    mpi.MPI_Info_set(inf, "a", "b")
    assert mpi.MPI_Info_get(inf, "a") == (True, "b")
    assert mpi.MPI_Info_get_nkeys(inf) == 1
    kv = mpi.MPI_Comm_create_keyval()
    assert kv > 0
    mpi.MPI_Comm_free_keyval(kv)
    assert callable(mpi.PMPI_Info_set)  # PMPI aliases cover new names


# ---- inheritance ----------------------------------------------------

def test_errhandler_inherited_by_split_create_group(pkg):
    """MPI: newly created communicators inherit the parent's error
    handler (not just dup)."""
    Group = pkg.imp("comm.communicator").Group

    def fn(comm):
        h = pkg.eh.Errhandler(lambda c, code: None)
        comm.Set_errhandler(h)
        sub = comm.split(0, comm.rank)
        cg = comm.create_group(Group(list(range(comm.size))))
        cr = comm.create(Group(list(range(comm.size))))
        got = [c.Get_errhandler() is h for c in (sub, cg, cr)]
        for c in (sub, cg, cr):
            c.free()
        return got

    assert pkg.run_ranks(2, fn) == [[True] * 3] * 2


def test_errhandler_inherited_by_intercomm_and_merge(pkg):
    intercomm_create = pkg.imp("comm.intercomm").intercomm_create

    def fn(comm):
        h = pkg.eh.Errhandler(lambda c, code: None)
        comm.Set_errhandler(h)
        low = comm.rank < 1
        local = comm.split(0 if low else 1)
        local.Set_errhandler(h)
        inter = intercomm_create(local, 0, comm, 1 if low else 0)
        merged = inter.merge(high=not low)
        return inter.Get_errhandler() is h, merged.Get_errhandler() is h

    assert pkg.run_ranks(2, fn) == [(True, True)] * 2


def test_keyval_free_deferred_while_attached(pkg):
    """free_keyval while values are attached must defer: later dup
    still runs the copy callback; final delete runs the delete
    callback; the entry disappears only when the last value is gone."""
    attrs = pkg.attrs
    events = []

    class Obj:
        def __init__(self):
            self.attrs = {}

    kv = attrs.create_keyval(
        copy_fn=lambda o, k, extra, v: v + 1,
        delete_fn=lambda o, k, v, extra: events.append(("del", v)))
    a = Obj()
    attrs.set_attr(a, kv, 10)
    attrs.free_keyval(kv)          # deferred: still attached to a
    b = Obj()
    attrs.copy_all(a, b)           # copy callback must still run
    assert b.attrs[kv] == 11
    # attaching NEW values through a freed keyval is erroneous
    with pytest.raises(ValueError):
        attrs.set_attr(Obj(), kv, 1)
    attrs.delete_all(a)
    attrs.delete_all(b)
    assert events == [("del", 10), ("del", 11)]
    # now fully released: the keyval is gone
    with pytest.raises(ValueError):
        attrs.set_attr(Obj(), kv, 1)


# ---- mpi_errhandler_world_default ----------------------------------

def test_world_default_fatal_param(pkg):
    """mpi_errhandler_world_default fatal restores the reference C
    default: the predefined comms come up FATAL, derived comms inherit
    it, and an error aborts via the rte (SystemExit in thread
    worlds)."""
    registry, eh = pkg.registry, pkg.eh
    eh.world_default()  # registers the variable
    prior = registry.get("mpi_errhandler_world_default", "return")
    registry.set("mpi_errhandler_world_default", "fatal")
    try:
        def fn(comm):
            st = comm.state
            got = [c.Get_errhandler() is eh.ERRORS_ARE_FATAL
                   for c in (comm, st.comm_self, comm.dup())]
            try:
                comm.Send(np.zeros(1), dest=99)
            except SystemExit:
                return got, "aborted"
            return got, "no-abort"

        assert pkg.run_ranks(1, fn) == [([True] * 3, "aborted")]
    finally:
        registry.set("mpi_errhandler_world_default", prior)


def test_handlerless_object_resolves_through_world(pkg):
    """An errhandler-less MPI object dispatches through COMM_WORLD's
    installed handler (OMPI_ERRHANDLER_INVOKE(NULL, ...) analog), not
    straight to the compiled-in default."""
    eh = pkg.eh

    def fn(comm):
        hits = []
        comm.Set_errhandler(eh.Errhandler(
            lambda obj, code: hits.append(code)))

        class Bare:  # e.g. a window/file before its handler is set
            state = comm.state

        with pytest.raises(eh.MPIException):
            eh.dispatch(Bare(), eh.MPIException(eh.ERR_IO))
        return hits

    assert pkg.run_ranks(1, fn) == [[pkg.eh.ERR_IO]]


def test_keyval_free_unattached_is_immediate(pkg):
    attrs = pkg.attrs

    class Obj:
        def __init__(self):
            self.attrs = {}

    kv = attrs.create_keyval()
    attrs.free_keyval(kv)
    with pytest.raises(ValueError):
        attrs.set_attr(Obj(), kv, 1)
