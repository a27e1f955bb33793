"""Parity of results between the two launchers: one rank program,
written here and run by both packages — under the reference's mpirun
(``JAX_PLATFORMS=cpu``) and under the port's (``--devices cpu``) — on 4
ranks in two app shells of 2.  It covers a token ring, ``Allreduce`` in
int32 and float32 on seeded numpy inputs, a chunked ``send_arr`` and a
world ``allreduce_arr`` across the two shells.  Integer and
data-movement results must match byte for byte; a float SUM must fall
within the reassociation band |port - ref| <= N * 2**-24 * sum|x_i|
(N ranks; element by element)."""

import json
import textwrap

import numpy as np

from ompi_tpu.testing import mpirun_run as ref_mpirun_run
from ompi_tpu_torch.testing import mpirun_run

N, RPP, SEED = 4, 2, 1234
CHUNK = 65536

PROG = textwrap.dedent("""
    import hashlib, importlib, json, sys
    import numpy as np
    name = sys.argv[1]
    pkg = importlib.import_module(name)
    op = importlib.import_module(name + ".op.op")
    comm = pkg.init()
    rank, size = comm.rank, comm.size
    rng = np.random.default_rng(%(seed)d + rank)
    out = {}

    def h(a):
        return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()

    # token ring across both shells
    tok = np.array([rank * 10 + 1], np.int32)
    got = np.zeros(1, np.int32)
    comm.Sendrecv(tok, (rank + 1) %% size, 5, got, (rank - 1) %% size, 5)
    out["ring"] = int(got[0])
    xi = rng.integers(-1000, 1000, 4099, dtype=np.int32)
    ri = np.empty_like(xi)
    comm.Allreduce(xi, ri, op.SUM)
    out["allreduce_i32"] = h(ri)
    xf = rng.standard_normal(4099).astype(np.float32)
    rf = np.empty_like(xf)
    comm.Allreduce(xf, rf, op.SUM)
    out["allreduce_f32"] = rf.astype(np.float64).tolist()
    # a chunked send_arr from rank 0 to the last rank (other shell)
    big = np.random.default_rng(%(seed)d).standard_normal(
        3 * %(chunk)d // 4 + 7).astype(np.float32)
    if rank == 0:
        comm.send_arr(big, size - 1, tag=9)
    elif rank == size - 1:
        got = comm.recv_arr(0, tag=9)
        a = np.asarray(got.cpu() if hasattr(got, "cpu") else got)
        out["send_arr"] = h(a)
        out["send_arr_exact"] = a.tobytes() == big.tobytes()
    # world allreduce_arr across the two shells (ints: exact)
    xa = rng.integers(-50, 50, 1000, dtype=np.int32)
    if name == "ompi_tpu_torch":
        import torch
        xa_in = torch.from_numpy(xa).to(comm.device)
    else:
        xa_in = xa
    ya = comm.allreduce_arr(xa_in, op.SUM)
    ya = np.asarray(ya.cpu() if hasattr(ya, "cpu") else ya)
    out["allreduce_arr_i32"] = h(ya)
    comm.Barrier()
    with open("%%s/rank%%d.json" %% (sys.argv[2], rank), "w") as fh:
        json.dump(out, fh)
    pkg.finalize()
""") % {"seed": SEED, "chunk": CHUNK}


def _run(runner, pkg, prog, out, **kw):
    """Each rank writes its results to ``out``/rank<r>.json (one line of
    stdout per rank-thread could interleave in a shared shell)."""
    out.mkdir()
    r = runner(N, str(prog), pkg, str(out),
               mca=(("btl_tpu_chunk_bytes", str(CHUNK)),),
               timeout=240, job_timeout=180, **kw)
    assert r.returncode == 0, (pkg, r.stderr.decode()[-3000:])
    return {r: json.loads((out / f"rank{r}.json").read_text())
            for r in range(N)}


def test_port_mpirun_matches_reference_mpirun(tmp_path):
    prog = tmp_path / "parity_prog.py"
    prog.write_text(PROG)
    ref = _run(ref_mpirun_run, "ompi_tpu", prog, tmp_path / "ref",
               extra=("--ranks-per-proc", str(RPP)))
    port = _run(mpirun_run, "ompi_tpu_torch", prog, tmp_path / "port",
                rpp=RPP, devices="cpu")
    xf_abs = 0.0
    for r in range(N):  # each rank's float input, drawn as it draws it
        rng = np.random.default_rng(SEED + r)
        rng.integers(-1000, 1000, 4099, dtype=np.int32)
        xf_abs = xf_abs + np.abs(
            rng.standard_normal(4099).astype(np.float32).astype(np.float64))
    for r in range(N):
        p, q = port[r], ref[r]
        assert p["ring"] == q["ring"] == ((r - 1) % N) * 10 + 1
        for key in ("allreduce_i32", "allreduce_arr_i32"):
            assert p[key] == q[key], (r, key)
        band = N * 2.0 ** -24 * xf_abs
        diff = np.abs(np.array(p["allreduce_f32"]) -
                      np.array(q["allreduce_f32"]))
        assert (diff <= band).all(), (r, float(diff.max()))
    last = N - 1
    assert port[last]["send_arr"] == ref[last]["send_arr"]
    assert port[last]["send_arr_exact"] and ref[last]["send_arr_exact"]
