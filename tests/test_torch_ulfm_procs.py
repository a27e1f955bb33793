"""ULFM and self-healing respawn over the port's launched jobs
(ompi_tpu_torch/ft/ulfm.py's KV half: the note watcher ``start_watcher``
and the put-once ``_KvStore``; ft/respawn's epoch rewire; runtime/init's
``TPUMPI_ULFM`` and ``TPUMPI_RESPAWN`` handling; tools/hostrun's rank
deaths): analogs of the reference's tests/test_ulfm.py
``test_mpirun_ulfm_policy_process_ranks`` and tests/test_respawn.py
``test_mpirun_respawn_policy_process_ranks`` through the port's mpirun
with ``--devices cpu``, over process ranks and over app shells of two
rank-threads each (``--ranks-per-proc 2``).

The expected lines are the reference tests' own: three survivors of
size 3 summing 6.0 (forward recovery), four ranks of size 4 with one
digest, which the fault-free run's accumulator fixes (respawn).  Each
example's card digest (``CARD``) must agree on every rank and equal the
digest of the analytic result.

Pinned divergence: under the respawn policy the unit mpirun relaunches
is the launch unit that died — an app shell relaunches with every rank
it held, so two ranks report ``joined=1`` there (the reference's app
shells abort the job on a rank-thread's death).  The KV store's keys
are the reference's spellings, so the two packages' notes and tickets
read alike.
"""

import hashlib
import os

import numpy as np
import pytest

from ompi_tpu_torch.testing import mpirun_run

EX = os.path.join("ompi_tpu_torch", "examples")
KILL = (("ft_inject_plan", "rank_kill"), ("ft_inject_victim_rank", "1"),
        ("ft_inject_after", "0.8"))


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()


def _run(prog, rpp, policy, extra_mca=()):
    r = mpirun_run(4, os.path.join(EX, prog), "--device", "cpu",
                   "--mib", "1", rpp=rpp, devices="cpu" if rpp else None,
                   mca=(("errmgr_base_policy", policy),) + KILL
                   + tuple(extra_mca), timeout=120, job_timeout=90)
    out, err = r.stdout.decode(), r.stderr.decode()
    assert r.returncode == 0, (r.returncode, out[-800:], err[-3000:])
    return out, err


@pytest.mark.parametrize("rpp", [None, 2])
def test_mpirun_ulfm_policy_process_ranks(rpp):
    """ft_inject kills rank 1; the ulfm policy declares it failed
    instead of tearing the job down (through mpirun's note for a dead
    process, through its app shell's for a dead rank-thread), the
    survivors shrink and the job exits 0 on 3 ranks."""
    out, err = _run("ulfm_procs.py", rpp, "ulfm")
    lines = [ln for ln in out.splitlines() if ln.startswith("rank=")]
    assert len(lines) == 3, out[-800:]
    assert all("size=3" in ln and "sum=6.0" in ln for ln in lines), lines
    cards = {ln.split()[2] for ln in out.splitlines()
             if ln.startswith("CARD ")}
    assert cards == {_sha(np.full((1 << 20) // 4, 6.0, np.float32))}, out
    if rpp is None:
        assert "ulfm policy" in err, err[-2000:]


@pytest.mark.parametrize("rpp", [None, 2])
def test_mpirun_respawn_policy_process_ranks(rpp):
    """ft_inject kills rank 1; the respawn policy relaunches its launch
    unit under the same world rank(s), the replacement restores from a
    buddy copy and the job exits 0 at FULL size with every rank on the
    fault-free digest."""
    out, err = _run("respawn_procs.py", rpp, "respawn",
                    (("cr_buddy_degree", "1"),))
    lines = [ln for ln in out.splitlines() if ln.startswith("rank=")]
    assert len(lines) == 4, out[-800:]
    assert all("size=4" in ln for ln in lines), lines
    acc = np.full(8, 10.0 * sum(range(1, 41)))  # sum(rank+1) * sum(i+1)
    digests = {ln.split("digest=")[1].strip() for ln in lines}
    assert digests == {acc.tobytes().hex()[:24]}, lines
    assert sum("joined=1" in ln for ln in lines) == (rpp or 1), lines
    cards = {ln.split()[2] for ln in out.splitlines()
             if ln.startswith("CARD ")}
    assert cards == {_sha(acc * 4)}, out
    assert "respawn policy" in err, err[-2000:]


def test_kv_store_keys_match_reference():
    """The put-once store of ranks in several processes spells its KV
    keys as the reference's (``ulfm:agree:...``), claims a key once,
    and hands out shrink cids above the local counting range."""
    from ompi_tpu.ft import ulfm as ref_ulfm

    from ompi_tpu_torch.ft import ulfm
    from ompi_tpu_torch.runtime.kvstore import KVClient, KVServer
    for key in (("agree", 3, 0, "c", 1), ("shrink", 9, (0, 2)),
                ("respawn", 1, "d")):
        assert ulfm._KvStore._k(key) == ref_ulfm._KvStore._k(key)
    srv = KVServer(2)
    kv = KVClient(srv.addr)
    try:
        st = ulfm._KvStore(kv)
        assert st.try_get(("agree", 1, "d")) is None
        assert st.put_once(("agree", 1, "d"), [1, 2])
        assert not st.put_once(("agree", 1, "d"), [3])
        assert st.try_get(("agree", 1, "d")) == [1, 2]
        a, b = st.next_cid(), st.next_cid()
        assert 4096 <= a < b
    finally:
        kv.close()
        srv.close()


def test_store_choice():
    """A thread world holding every rank agrees over its shared table
    (a run_ranks world, a pool session); ranks in several processes over
    the KV store; a rank with neither has no store."""
    import types

    from ompi_tpu_torch.ft import ulfm
    from ompi_tpu_torch.runtime.rte import HybridWorld, InprocWorld

    def state(world, kv):
        return types.SimpleNamespace(
            rte=types.SimpleNamespace(world=world, kv=kv))

    kv = object()
    assert isinstance(ulfm._store(state(InprocWorld(4), kv)),
                      ulfm._InprocStore)
    assert isinstance(ulfm._store(state(HybridWorld(4, 0, 4), kv)),
                      ulfm._InprocStore)
    assert isinstance(ulfm._store(state(HybridWorld(4, 0, 2), kv)),
                      ulfm._KvStore)
    assert isinstance(ulfm._store(state(None, kv)), ulfm._KvStore)
    with pytest.raises(RuntimeError, match="store every rank sees"):
        ulfm._store(state(HybridWorld(4, 2, 2), None))
