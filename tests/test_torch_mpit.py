"""The MPI_T tool interface through both packages: ompi_tpu.mpit and
its port, ompi_tpu_torch.mpit — cvar enumeration, handles and writes,
stable indices, categories over the frameworks, pvar sessions and
handles (start, stop, read, reset) over pml/monitoring's matrices and
ob1's byte counters, the info tool, and the pvars other subsystems
publish (autotune's fold, the segment histogram, the tracer's
sampling and drop counts) read through MPI_T.

The analogs of tests/test_mpit.py's 15 tests (with
``test_monitoring_pvar_session_delta``), of the MPI_T reads in
tests/test_autotune.py, tests/test_coll_pipeline.py and
tests/test_trace.py (one parametrised test, both packages in each
case, their reads compared), and of tests/test_obs.py's pvar-index
stability test.  Each other test body runs once through each package
(ids ``port`` and ``ref``) on host buffers (CPU tensors, and the
reference's arrays, where the segmented allreduce is read), and both
are held to the same expected values.  Port only: the pool's metrics
RPC takes its pvars from ``mpit.pvar_snapshot``.

Tolerance: exact — counts, bytes, indices, names; the segmented
allreduce's bytes too (small-integer float32 sums).
"""

import importlib
import types

import jax
import numpy as np
import pytest
import torch

import ompi_tpu.coll.fusion  # noqa: F401  (registers the knobs below)
import ompi_tpu.coll.pipeline  # noqa: F401
import ompi_tpu_torch.coll.fusion  # noqa: F401
import ompi_tpu_torch.coll.pipeline  # noqa: F401

PKGS = ("ompi_tpu_torch", "ompi_tpu")
# every knob a test here sets, in either registry
KNOBS = ("pml_monitoring_enable", "trace_enable", "trace_dump_path",
         "trace_sample_spec", "trace_sample_auto", "trace_buffer_events",
         "coll_pipeline_enable", "coll_pipeline_min_bytes",
         "coll_seg_size", "coll_pipeline_rd_max_bytes",
         "coll_hier_enable", "coll_plan_enable", "coll_autotune_enable",
         "coll_autotune_interval_ops", "coll_autotune_ewma",
         "coll_autotune_min_samples", "coll_autotune_window_ops",
         "coll_autotune_fusion", "coll_tuned_use_measured_rules",
         "coll_tuned_profile_path")


def _pkg(name):
    def imp(sub):
        return importlib.import_module(f"{name}.{sub}")

    return types.SimpleNamespace(
        name=name, imp=imp, mpit=imp("mpit"),
        registry=imp("mca.params").registry,
        run_ranks=imp("testing").run_ranks)


@pytest.fixture(params=["port", "ref"])
def pkg(request):
    return _pkg(PKGS[0] if request.param == "port" else PKGS[1])


@pytest.fixture(autouse=True)
def _restore_knobs():
    """Every knob a test here sets goes back to its value in both
    registries, and the autotuner and profile caches are dropped."""
    saved = []
    for name in PKGS:
        reg = _pkg(name).registry
        saved.append((reg, {k: reg.get(k) for k in KNOBS
                            if reg.get(k) is not None}))
    yield
    for reg, vals in saved:
        for k, v in vals.items():
            reg.set(k, v)
    for name in PKGS:
        _pkg(name).imp("coll.autotune").reset()
        _pkg(name).imp("coll.calibrate").reset_cache()


@pytest.fixture
def mpit_session(pkg):
    pkg.mpit.init_thread()
    yield pkg.mpit
    pkg.mpit.finalize()


def test_mpit_requires_init(pkg):
    with pytest.raises(pkg.mpit.MpitError, match="NOT_INITIALIZED"):
        pkg.mpit.cvar_get_num()
    with pytest.raises(pkg.mpit.MpitError):
        pkg.mpit.finalize()


def test_cvar_enumeration_and_handles(mpit_session):
    mpit = mpit_session
    n = mpit.cvar_get_num()
    assert n > 10
    idx = mpit.cvar_get_index("pml_monitoring_enable")
    info = mpit.cvar_get_info(idx)
    assert info["name"] == "pml_monitoring_enable"
    assert info["type"] == "bool" and info["scope"] == "all"
    h = mpit.cvar_handle_alloc("pml_monitoring_enable")
    assert mpit.cvar_read(h) is False
    with pytest.raises(mpit.MpitError, match="INVALID_INDEX"):
        mpit.cvar_get_info(n)
    with pytest.raises(mpit.MpitError, match="INVALID_NAME"):
        mpit.cvar_get_index("no_such_variable")


def test_cvar_write_roundtrip(mpit_session, pkg):
    mpit = mpit_session
    h = mpit.cvar_handle_alloc("pml_monitoring_enable")
    mpit.cvar_write(h, True)
    assert mpit.cvar_read(h) is True
    assert pkg.registry.get("pml_monitoring_enable") is True
    mpit.cvar_write(h, False)
    assert mpit.cvar_read(h) is False


def test_categories_cover_frameworks(mpit_session):
    mpit = mpit_session
    infos = [mpit.category_get_info(i)
             for i in range(mpit.category_get_num())]
    names = {c["name"] for c in infos}
    assert {"coll", "pml", "btl"} <= names
    pml = next(c for c in infos if c["name"] == "pml")
    assert mpit.cvar_get_index("pml_monitoring_enable") \
        in pml["cvar_indices"]
    assert pml["num_cvars"] == len(pml["cvar_indices"])


def _monitored(pkg, fn, n=2):
    pkg.registry.set("pml_monitoring_enable", True)
    try:
        return pkg.run_ranks(n, fn)
    finally:
        pkg.registry.set("pml_monitoring_enable", False)


def test_monitoring_counts_traffic(pkg):
    def fn(comm):
        x = np.arange(64, dtype=np.float64)
        if comm.rank == 0:
            comm.Send(x, dest=1, tag=5)
        else:
            comm.Recv(np.empty_like(x), source=0, tag=5)
        comm.Barrier()
        return comm.state.pml.matrix_rows()

    rows = _monitored(pkg, fn)
    # rank0 sent one user message of 512 bytes to peer 1
    assert rows[0]["sent_msgs"] == [0, 1]
    assert rows[0]["sent_bytes"] == [0, 512]
    assert rows[1]["recv_bytes"][0] == 512
    # internal traffic (tag < 0) is counted apart from the user's
    assert rows[0]["sent_filtered_msgs"][1] >= 1
    assert rows[1]["sent_msgs"] == [0, 0]


def test_monitoring_pvar_session_delta(pkg):
    mpit = pkg.mpit

    def fn(comm):
        mpit.init_thread()
        s = mpit.pvar_session_create()
        h = mpit.pvar_handle_alloc(s, "pml_monitoring_messages_size")
        base = mpit.pvar_read(h)
        mpit.pvar_reset(h)
        if comm.rank == 0:
            comm.Send(np.zeros(32, dtype=np.float64), dest=1, tag=0)
        else:
            comm.Recv(np.empty(32, dtype=np.float64), source=0, tag=0)
        delta = mpit.pvar_read(h)
        mpit.pvar_session_free(s)
        mpit.finalize()
        return base, delta

    res = _monitored(pkg, fn)
    assert res[0][1] == [0, 256]      # bytes to peer 1 since reset
    assert res[1][1] == [0, 0]        # rank 1 sent nothing


def test_monitoring_dump(pkg, tmp_path):
    def fn(comm):
        if comm.rank == 0:
            comm.Send(np.zeros(8, dtype=np.int64), dest=1, tag=0)
        else:
            comm.Recv(np.empty(8, dtype=np.int64), source=0, tag=0)
        path = str(tmp_path / f"prof.{comm.rank}")
        comm.state.pml.dump(path)
        return path

    paths = _monitored(pkg, fn)
    assert open(paths[0]).read().strip().splitlines() == ["0 1 1 64"]


def test_monitoring_disabled_no_wrap(pkg):
    def fn(comm):
        return hasattr(comm.state.pml, "matrix_rows")

    assert pkg.run_ranks(2, fn) == [False, False]


def test_pvar_stop_freezes_value(mpit_session, pkg):
    mpit = mpit_session

    def fn(comm):
        s = mpit.pvar_session_create()
        h = mpit.pvar_handle_alloc(s, "pml_monitoring_messages_count")
        if comm.rank == 0:
            comm.Send(np.zeros(4, dtype=np.int64), dest=1, tag=0)
            mpit.pvar_stop(h)
            frozen = mpit.pvar_read(h)
            comm.Send(np.zeros(4, dtype=np.int64), dest=1, tag=0)
            still = mpit.pvar_read(h)
            mpit.pvar_start(h)
            live = mpit.pvar_read(h)
            return frozen, still, live
        comm.Recv(np.empty(4, dtype=np.int64), source=0, tag=0)
        comm.Recv(np.empty(4, dtype=np.int64), source=0, tag=0)
        return None

    assert _monitored(pkg, fn)[0] == ([0, 1], [0, 1], [0, 2])


def test_cvar_index_stable_across_new_registrations(mpit_session, pkg):
    mpit = mpit_session
    idx = mpit.cvar_get_index("pml_monitoring_enable")
    # an alphabetically-earlier registration must NOT shift indices
    pkg.registry.register("aaa", "zzz", "newvar", 1, int)
    assert mpit.cvar_get_index("pml_monitoring_enable") == idx
    assert mpit.cvar_get_info(idx)["name"] == "pml_monitoring_enable"
    assert mpit.cvar_get_index("aaa_zzz_newvar") > idx


def test_monitoring_anytag_irecv_counts_as_user(pkg):
    def fn(comm):
        if comm.rank == 0:
            comm.Send(np.zeros(16, dtype=np.float64), dest=1, tag=9)
            return None
        r = np.empty(16, dtype=np.float64)
        comm.Irecv(r, source=0).wait()   # default tag = ANY_TAG
        return comm.state.pml.matrix_rows()

    assert _monitored(pkg, fn)[1]["recv_bytes"] == [128, 0]


def test_neighbor_buffer_divisibility_error(pkg):
    def fn(comm):
        cart = comm.Create_cart([3], periods=[True])
        try:
            cart.Neighbor_allgather(np.zeros(1), np.zeros(5))
            return "no-error"
        except ValueError:
            return "ok"

    assert pkg.run_ranks(3, fn) == ["ok"] * 3


def test_cart_coords_invalid_rank_raises(pkg):
    def fn(comm):
        cart = comm.Create_cart([2, 2])
        try:
            cart.Get_coords(7)
            return "no-error"
        except ValueError:
            return "ok"

    assert pkg.run_ranks(4, fn) == ["ok"] * 4


def test_info_tool_output(pkg, capsys):
    info = pkg.imp("tools.info")
    assert info.main([]) == 0
    out = capsys.readouterr().out
    assert "Components:" in out and "coll" in out
    assert info.main(["--param", "all", "all", "--parsable"]) == 0
    out = capsys.readouterr().out
    assert "mca:" in out and ":param:" in out and ":source:" in out


def test_pvar_counts_fast_and_slow_send_paths(pkg):
    """The ob1 bytes_sent pvar counts both convertor paths: the
    contiguous fast path and the stack-machine slow path (strided)."""
    conv = pkg.imp("datatype.convertor")
    dtmod = pkg.imp("datatype.engine")
    vec = dtmod.vector(8, 1, 2, dtmod.DOUBLE).commit()
    flat = np.arange(16, dtype=np.float64)
    assert isinstance(conv.make_convertor(dtmod.DOUBLE, 16, flat),
                      conv.ContigConvertor)
    assert not isinstance(conv.make_convertor(vec, 1, flat),
                          conv.ContigConvertor)

    def fn(comm):
        pv = comm.state.pml.pvar_sent
        if comm.rank == 0:
            base = pv.read()
            comm.Send(flat, dest=1, tag=7)              # fast path
            fast = pv.read() - base
            base = pv.read()
            comm.Send((flat, 1, vec), dest=1, tag=9)    # slow path
            return fast, pv.read() - base
        r = np.empty(16, dtype=np.float64)
        comm.Recv(r, source=0, tag=7)
        r8 = np.empty(8, dtype=np.float64)
        comm.Recv(r8, source=0, tag=9)
        return r8.tobytes()

    res = pkg.run_ranks(2, fn)
    assert res[0] == (16 * 8, 8 * 8)
    assert res[1] == flat[::2].tobytes()


def test_pvar_indices_stable_after_obs_registration(pkg):
    """MPI_T requires pvar indices never move once handed out.  The
    obs gauges append; re-registration is a no-op."""
    mpit, obs, registry = pkg.mpit, pkg.imp("obs"), pkg.registry
    mpit.init_thread()
    try:
        obs.register_pvars()  # may already have run — idempotent
        names = [p.full_name
                 for p in registry.pvars_in_registration_order()]
        idx = {n: mpit.pvar_get_index(n) for n in names[:8]}
        obs.register_pvars()
        obs.register_pvars()
        names2 = [p.full_name
                  for p in registry.pvars_in_registration_order()]
        assert names2 == names, "re-registration moved or added pvars"
        assert len(set(names2)) == len(names2), "duplicate pvar names"
        for n, i in idx.items():
            assert mpit.pvar_get_index(n) == i
        for want in ("obs_p50_progress_tick", "obs_p99_serve_attach",
                     "obs_events_recorded", "obs_events_dropped",
                     "obs_scrapes"):
            assert mpit.pvar_get_info(mpit.pvar_get_index(want))["name"] \
                == want
    finally:
        mpit.finalize()


# -- other subsystems' pvars read through MPI_T -----------------------------

def _read(mpit, *names):
    mpit.init_thread()
    try:
        sess = mpit.pvar_session_create()
        return [mpit.pvar_read(mpit.pvar_handle_alloc(sess, n))
                for n in names]
    finally:
        mpit.finalize()


def _autotune_case(p, tmp_path):
    """A fold over skewed histograms (slow whole-op dispatch, fast
    per-segment meets: ratio 1/8) pulls the allreduce crossover from
    1 GiB to 2 * seg_bytes / 8; MPI_T reads the fold count and the
    crossover."""
    cal, at, trace = (p.imp("coll.calibrate"), p.imp("coll.autotune"),
                      p.imp("trace"))
    path = str(tmp_path / f"{p.name}-prof.json")
    p.registry.set("coll_tuned_profile_path", path)
    cal.reset_cache()
    cal.save_profile({
        "host": "test", "backend": "crafted", "source": "crafted",
        "host_alpha_us": 5.0, "host_gbs": 10.0, "dispatch_us": 200.0,
        "seg_bytes": 1 << 20,
        "seg_crossover_bytes": {"allreduce": 1 << 30, "bcast": 1 << 30,
                                "alltoall": 1 << 30},
        "hier_min_bytes": 1 << 30}, path)
    for k, v in {"coll_tuned_use_measured_rules": "1",
                 "coll_autotune_enable": "1",
                 "coll_autotune_interval_ops": "1000000000",
                 "coll_autotune_ewma": "1.0",
                 "coll_autotune_min_samples": "8",
                 "coll_autotune_window_ops": "4",
                 "coll_autotune_fusion": "0",
                 "trace_enable": "1"}.items():
        p.registry.set(k, v)
    at.reset()

    def fn(comm):
        tr = comm.state.tracer
        if comm.rank == 0:
            tr.hists[trace.HIST_COLL_DISPATCH][10] += 200
            tr.hists[trace.HIST_COLL_SEGMENT][7] += 200
        comm.Barrier()
        if comm.rank == 0:
            assert at.active().fold() is True
        comm.Barrier()
        return _read(p.mpit, "coll_autotune_folds",
                     "coll_autotune_seg_crossover_allreduce")

    res = p.run_ranks(2, fn)
    assert res == [[1, 262144]] * 2
    return res


def _pipeline_case(p, tmp_path):
    """A segmented allreduce_arr: the coll_segment histogram, read
    through MPI_T, counts the rank's segment spans."""
    trace = p.imp("trace")
    op = p.imp("op.op")
    for k, v in {"coll_pipeline_enable": True,
                 "coll_pipeline_min_bytes": 2048, "coll_seg_size": 4096,
                 "coll_pipeline_rd_max_bytes": 0,
                 "coll_hier_enable": False, "coll_plan_enable": False,
                 "trace_enable": "1", "trace_sample_auto": "0",
                 "trace_buffer_events": "65536",
                 "trace_dump_path": ""}.items():
        p.registry.set(k, v)
    if p.name == "ompi_tpu":
        def put(a, comm):
            return jax.device_put(a, comm.device)
        dmap = lambda r: jax.devices()[0]  # noqa: E731
    else:
        def put(a, comm):
            return torch.from_numpy(a)
        dmap = lambda r: torch.device("cpu")  # noqa: E731

    def fn(comm):
        x = put((np.arange(4099, dtype=np.float32) % 11) + comm.rank, comm)
        y = comm.allreduce_arr(x, op.SUM)
        tr = comm.state.tracer
        segs = sum(1 for e in tr.snapshot() if e["cat"] == "coll_segment")
        assert tr.hist_total(trace.HIST_COLL_SEGMENT) == segs
        (hist,) = _read(p.mpit, "trace_hist_coll_segment")
        return segs, sum(hist), np.asarray(y).tobytes()

    res = p.run_ranks(4, fn, device_map=dmap)
    want = ((np.arange(4099, dtype=np.float32) % 11) * 4 + 6).tobytes()
    for segs, hist, y in res:
        assert segs > 1 and hist == segs and y == want
    return [r[:2] for r in res]


def _trace_case(p, tmp_path):
    """1-in-8 sampling of the coll category: MPI_T reads the sampling
    table and the drop count the tracer keeps."""
    for k, v in {"trace_enable": "1",
                 "trace_dump_path": str(tmp_path / p.name),
                 "trace_sample_spec": "coll:8"}.items():
        p.registry.set(k, v)
    (tmp_path / p.name).mkdir()

    def fn(comm):
        for _ in range(32):
            comm.Barrier()
        rates, dropped = _read(p.mpit, "trace_sampling_rate",
                               "trace_dropped_coll")
        assert dropped == comm.state.tracer.dropped_by_cat()["coll"]
        return rates["coll"], dropped

    res = p.run_ranks(2, fn)
    assert all(rate == 8 and dropped > 0 for rate, dropped in res)
    return res


@pytest.mark.parametrize("case", [_autotune_case, _pipeline_case,
                                  _trace_case],
                         ids=["autotune", "pipeline", "trace"])
def test_mpit_reads_subsystem_pvars(case, tmp_path):
    """Both packages, one after the other: the same reads."""
    assert case(_pkg(PKGS[0]), tmp_path) == case(_pkg(PKGS[1]), tmp_path)


def test_pool_metrics_read_pvars_through_mpit(tmp_path, monkeypatch):
    """The resident pool's metrics RPC takes its pvars from MPI_T's
    snapshot (one registry read, no copy of its own)."""
    import ompi_tpu_torch.mpit as mpit
    from ompi_tpu_torch.tools.dvm import DVMServer, DvmClient
    calls = []
    real = mpit.pvar_snapshot

    def snapshot(prefix=None):
        out = real(prefix)
        calls.append(out)
        return out

    monkeypatch.setattr(mpit, "pvar_snapshot", snapshot)
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(2, devices=[torch.device("cpu")], uri_file=uri).start()
    try:
        with DvmClient(uri) as c:
            m = c.metrics(events=0)
    finally:
        srv.stop()
    assert len(calls) == 1
    assert m["pvars"] == calls[0] and "dvm_sessions_active" in m["pvars"]
