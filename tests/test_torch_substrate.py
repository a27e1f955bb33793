"""The port's host substrate (mca, runtime, datatype, op, pml, btl,
host collectives) against the reference, and the port's isolation
from jax and from the reference package.

Host-path results must be byte-equal through both packages: the same
numpy buffers, the same algorithms (coll/tuned over ob1 over the
in-process btl)."""

import os
import re
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu_torch
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch.datatype import engine as port_dt
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

PKG_DIR = os.path.dirname(os.path.abspath(ompi_tpu_torch.__file__))
REPO = os.path.dirname(PKG_DIR)


def _host_program(op_mod, seed):
    """Blocking host collectives on numpy int32 buffers."""
    def fn(comm):
        rng = np.random.default_rng(seed + comm.rank)
        a = rng.integers(-1000, 1000, 24).astype(np.int32)
        out = {}
        for name in ("SUM", "MAX", "BXOR", "PROD"):
            r = np.empty_like(a)
            comm.Allreduce(a, r, getattr(op_mod, name))
            out[f"allreduce_{name}"] = r
        b = a.copy() if comm.rank == 1 else np.zeros_like(a)
        comm.Bcast(b, root=1)
        out["bcast"] = b
        g = np.empty(a.size * comm.size, np.int32)
        comm.Allgather(a, g)
        out["allgather"] = g
        t = np.empty_like(a)
        comm.Alltoall(a, t)
        out["alltoall"] = t
        rs = np.empty(a.size // comm.size, np.int32)
        comm.Reduce_scatter_block(a, rs, op_mod.SUM)
        out["reduce_scatter_block"] = rs
        s = np.empty_like(a)
        comm.Scan(a, s, op_mod.SUM)
        out["scan"] = s
        red = np.empty_like(a) if comm.rank == 0 else None
        comm.Reduce(a, red, op_mod.MIN, root=0)
        out["reduce"] = red
        return out
    return fn


@pytest.mark.parametrize("n", [2, 3, 4])
def test_host_collectives_byte_equal(n):
    port = port_run_ranks(n, _host_program(port_op, 100 * n))
    ref = ref_run_ranks(n, _host_program(ref_op, 100 * n))
    for p, r in zip(port, ref):
        assert p.keys() == r.keys()
        for k in p:
            if r[k] is None:
                assert p[k] is None
                continue
            assert p[k].dtype == r[k].dtype
            assert p[k].tobytes() == r[k].tobytes(), k


def test_p2p_and_split_match_reference():
    """Send/Recv on a ring, then a split communicator's allreduce."""
    def fn(comm, op_mod):
        right, left = (comm.rank + 1) % comm.size, \
            (comm.rank - 1) % comm.size
        msg = np.arange(5, dtype=np.float64) + comm.rank
        got = np.empty(5, np.float64)
        req = comm.Irecv(got, left, 7)
        comm.Send(msg, right, 7)
        req.wait()
        sub = comm.split(comm.rank % 2, key=-comm.rank)
        r = np.empty(1, np.int64)
        sub.Allreduce(np.array([comm.rank], np.int64), r, op_mod.SUM)
        return got.tolist(), sub.rank, sub.size, int(r[0])

    port = port_run_ranks(4, lambda c: fn(c, port_op))
    ref = ref_run_ranks(4, lambda c: fn(c, ref_op))
    assert port == ref


def _example_imports():
    """Every module the port's example programs import (an example runs
    a job when imported, so its imports stand in for it)."""
    import ast
    ex = os.path.join(PKG_DIR, "examples")
    mods = set()
    for f in sorted(os.listdir(ex)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(ex, f), encoding="utf-8").read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods.add(node.module)
    return sorted(mods)


def test_port_imports_no_jax_and_no_reference():
    """In a fresh interpreter, importing the port (its device path and
    its pml interposers included) and every module its example
    programs import loads neither jax nor the reference package."""
    code = ("import sys, ompi_tpu_torch, ompi_tpu_torch.coll.device, "
            "ompi_tpu_torch.testing, ompi_tpu_torch.kernels.stacked, "
            "ompi_tpu_torch.kernels.build, ompi_tpu_torch.convert, "
            "ompi_tpu_torch.coll.fusion, ompi_tpu_torch.coll.plan, "
            "ompi_tpu_torch.coll.calibrate, ompi_tpu_torch.coll.nbc, "
            "ompi_tpu_torch.datatype.device, ompi_tpu_torch.kernels.fused, "
            "ompi_tpu_torch.kernels.index, ompi_tpu_torch.runtime.kvstore, "
            "ompi_tpu_torch.btl.tcp, ompi_tpu_torch.btl.shm, "
            "ompi_tpu_torch.tools.mpirun, ompi_tpu_torch.tools.hostrun, "
            "ompi_tpu_torch.tools.dvm, ompi_tpu_torch.serve.quota, "
            "ompi_tpu_torch.serve.controller, ompi_tpu_torch.obs.reqtrace, "
            "ompi_tpu_torch.pml.persistent, ompi_tpu_torch.pml.monitoring, "
            "ompi_tpu_torch.pml.vprotocol, ompi_tpu_torch.cr, "
            "ompi_tpu_torch.comm.intercomm, ompi_tpu_torch.comm.dpm, "
            "ompi_tpu_torch.coll.inter, ompi_tpu_torch.coll.sm, "
            "ompi_tpu_torch.coll.seg, ompi_tpu_torch.tools.top, "
            "ompi_tpu_torch.tools.attach, ompi_tpu_torch.mpi, "
            "ompi_tpu_torch.mpit, ompi_tpu_torch.attrs, "
            "ompi_tpu_torch.memchecker, ompi_tpu_torch.util.output, "
            "ompi_tpu_torch.runtime.dfs, ompi_tpu_torch.testing.flat, "
            + ", ".join(_example_imports()) + "\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or "
            "m == 'ompi_tpu' or m.startswith('ompi_tpu.'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=REPO, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]", res.stdout


def test_no_port_file_names_jax_or_the_reference():
    """No source file of the port (nor chip_smoke.py) imports jax or
    names the reference package as a module (``ompi_tpu.`` without
    the ``_torch`` suffix)."""
    bad_pat = re.compile(r"^\s*(import jax|from jax)|\bompi_tpu\.",
                         re.MULTILINE)
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG_DIR)
             for f in fs if f.endswith((".py", ".cu", ".cuh"))]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    offenders = [f for f in files
                 if bad_pat.search(open(f, encoding="utf-8").read())]
    assert offenders == []


def test_devices_true_without_a_card_raises():
    """The device entry point defaults to the card and never falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        port_run_ranks(2, lambda c: None, devices=True)


def test_convert_round_trips_every_dtype():
    """numpy <-> torch, bfloat16 through a 16-bit view, bool kept."""
    rng = np.random.default_rng(5)
    for dt in (np.float16, np.float32, np.float64, np.int8, np.uint8,
               np.int32, np.int64, np.bool_, ml_dtypes.bfloat16):
        a = rng.standard_normal(9).astype(dt) if dt != np.bool_ \
            else rng.integers(0, 2, 9).astype(np.bool_)
        t = convert.to_torch(a, torch.device("cpu"))
        assert t.dtype == convert.torch_dtype(a.dtype)
        back = convert.to_numpy(t)
        assert back.dtype == a.dtype
        assert back.tobytes() == a.tobytes()
    bf = convert.to_torch(np.array([1.5, -2.0], ml_dtypes.bfloat16),
                          torch.device("cpu"))
    assert bf.tolist() == [1.5, -2.0]
    ro = np.arange(3, dtype=np.int32)
    ro.setflags(write=False)
    assert convert.to_torch(ro, torch.device("cpu")).tolist() == [0, 1, 2]


def test_mpi_dtype_of_tensors():
    """A tensor's MPI datatype is the one the reference picks for the
    same numpy dtype (bfloat16 included)."""
    from ompi_tpu.datatype import engine as ref_dt
    for t in (torch.zeros(2), torch.zeros(2, dtype=torch.int8),
              torch.zeros(2, dtype=torch.float64),
              torch.zeros(2, dtype=torch.bool),
              torch.zeros(2, dtype=torch.bfloat16)):
        want = ref_dt.from_numpy_dtype(convert.numpy_dtype(t.dtype))
        got = convert.mpi_dtype_of(t)
        assert (got.name, got.size) == (want.name, want.size)
    assert convert.mpi_dtype_of(torch.zeros(1)) is port_dt.FLOAT


def test_mca_names_match_the_reference():
    """An --mca setting means the same thing to both packages: the
    hbm path's parameters keep their names and defaults."""
    from ompi_tpu.mca.params import registry as ref_registry
    import ompi_tpu.coll.device  # noqa: F401  (registers)
    import ompi_tpu.coll.fusion  # noqa: F401
    import ompi_tpu.coll.plan  # noqa: F401
    import ompi_tpu_torch.coll.device  # noqa: F401
    import ompi_tpu_torch.coll.fusion  # noqa: F401
    import ompi_tpu_torch.coll.plan  # noqa: F401
    for name in ("coll_hbm_priority", "coll_device_rendezvous_timeout",
                 "coll_device_rendezvous_poll",
                 "coll_device_reduce_as_allreduce",
                 "coll_tuned_allreduce_small_msg", "rte_base_fence_timeout"):
        assert port_registry.get(name) == ref_registry.get(name), name
    # the tier knobs, by default (tests set and restore them)
    defaults = [{v.full_name: v.default for v in reg.all_vars()}
                for reg in (port_registry, ref_registry)]
    for name in ("coll_device_dispatcher", "coll_pipeline_enable",
                 "coll_pipeline_min_bytes", "coll_seg_size",
                 "coll_pipeline_depth", "coll_pipeline_rd_max_bytes",
                 "coll_plan_enable", "coll_plan_cache_max",
                 "coll_device_fusion", "coll_device_fusion_threshold",
                 "coll_device_fusion_max_ops",
                 "coll_tuned_use_measured_rules"):
        assert defaults[0][name] == defaults[1][name], name
    from ompi_tpu.mca.params import ENV_PREFIX as ref_prefix
    from ompi_tpu_torch.mca.params import ENV_PREFIX
    assert ENV_PREFIX == ref_prefix == "TPUMPI_MCA_"


def test_op_tables_match_the_reference():
    """Op validity and the host reductions of the copied op table."""
    rng = np.random.default_rng(2)
    a = rng.integers(-9, 9, 16).astype(np.int32)
    b = rng.integers(-9, 9, 16).astype(np.int32)
    for name, pop in port_op.PREDEFINED.items():
        rop = ref_op.PREDEFINED[name]
        for dt in (np.float32, np.int8, np.bool_, np.complex64):
            assert pop.valid_for(np.dtype(dt)) == rop.valid_for(np.dtype(dt))
        if pop.np_fn is not None:
            assert pop.reduce(a, b).tobytes() == rop.reduce(a, b).tobytes()
        tb = port_op.torch_binary(pop)
        if tb is not None:
            got = tb(torch.from_numpy(a), torch.from_numpy(b)).numpy()
            assert got.tobytes() == rop.reduce(a, b).tobytes(), name
