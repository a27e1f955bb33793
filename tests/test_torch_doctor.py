"""The hang doctor (tools/doctor.py), its request ids (obs/reqtrace.py),
the meeting's snapshot (``Rendezvous.snapshot``), the ``rdv_sever``
injector and the capture builder (``testing.sessions.doctor_capture``)
through both packages where the reference has them.

Ports the offline cases of tests/test_reqtrace.py (:41-70 fmt and
parse, on ids the reference mints; :198-256 the verdict, its fallbacks, ``load_captures`` and the
CLI): the port's doctor gives the reference's lines and output on the
same documents.  The live cases run the port only, since the
reference builds captures inside its DVM pool, which the port has not
(A8): ``rdv_sever`` wedges rank 2 of 4 short of its first deposit on
the hbm tier (every rank on the CPU device) and on the mesh tier (one
logical CPU device a rank); a watcher thread builds the capture once
the other three have arrived, the verdict (the same lines through the
reference's reducer) names rank 2 as absent, and poisoning the world
unwinds every rank, the wedged one included, well inside the
rendezvous timeout.

Tolerance: exact (strings, integers).
"""

import json
import threading
import time

import pytest
import torch

import ompi_tpu.ft_inject as ref_fi
from ompi_tpu.coll import device as ref_device
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.obs import reqtrace as ref_reqtrace
from ompi_tpu.tools import doctor as ref_doctor
from ompi_tpu_torch import convert, obs
from ompi_tpu_torch import ft_inject as port_fi
from ompi_tpu_torch.coll import device as port_device
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.obs import health as port_health
from ompi_tpu_torch.obs import reqtrace as port_reqtrace
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import RankError, logical_devices, run_ranks
from ompi_tpu_torch.testing import sessions
from ompi_tpu_torch.tools import doctor as port_doctor

CPU = torch.device("cpu")
MS = 1_000_000


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


# -- request ids ------------------------------------------------------------

@pytest.mark.parametrize("source", ["minted", "edges"])
def test_fmt_parse_roundtrip_matches_reference(source):
    """fmt and parse round-trip in hex and decimal and give the
    reference's strings and ids: on ids the reference mints (the
    minting half is the pool's, A8) and on the edges of the 63-bit
    range."""
    if source == "minted":
        tids = [ref_reqtrace.mint()[0] for _ in range(200)]
    else:
        tids = [1, 0xdeadbeef, (1 << 63) - 1]
    for t in tids:
        assert port_reqtrace.fmt(t) == ref_reqtrace.fmt(t)
        assert port_reqtrace.parse(port_reqtrace.fmt(t)) == t
        assert port_reqtrace.parse(str(t)) == ref_reqtrace.parse(str(t)) \
            == t
        assert port_reqtrace.parse(f" {port_reqtrace.fmt(t).upper()} ") \
            == ref_reqtrace.parse(f" {ref_reqtrace.fmt(t).upper()} ")


@pytest.mark.parametrize("bad", ["not-a-tid", "0xzz", ""])
def test_parse_refuses_what_the_reference_refuses(bad):
    with pytest.raises(ValueError):
        port_reqtrace.parse(bad)
    with pytest.raises(ValueError):
        ref_reqtrace.parse(bad)


# -- the verdict reducer on documents ------------------------------------------

def _capture_doc(sid=5, tid=0x9):
    return {
        "sid": sid, "tid": tid, "span": 2, "ns": f"s{sid}", "np": 4,
        "run_ms": 900, "est_ms": 100, "factor_pct": 200,
        "mttd_ms": 12.5, "aborted": None,
        "stacks": {f"dvm-s{sid}-r0": ["  File x, line 1, in wait\n"]},
        "rendezvous": [{"cid": 1, "gen": 3, "size": 4, "count": 3,
                        "arrived": [0, 1, 3], "absent": [2],
                        "pending_gens": [], "group": [4, 5, 6, 7]}],
        "fences": {"f1": {"arrived_weight": 2, "waiters": 1,
                          "arrivals": {"4": 1, "5": 1}}},
        "events": [{"name": "wd_stall", "cat": "flight", "ph": "i",
                    "ts": 1.0, "rank": -1,
                    "args": {"sid": sid, "tid": tid}}],
    }


def _variant(name):
    doc = _capture_doc()
    if name == "no_rdv":
        doc["rendezvous"] = []
    elif name == "local":
        doc["rendezvous"], doc["fences"] = [], {}
    elif name == "aborted":
        doc["aborted"] = [2, 1, "boom"]
    elif name == "sdc":
        doc["sdc"] = [{"rank": 1, "host": 0, "cid": 3, "kind": "allreduce"}]
    elif name == "no_tid":
        doc["tid"] = 0
    elif name == "unknown_slot":
        doc["rendezvous"][0]["absent"] = [2, 9]
    elif name == "straggling_absent":
        doc["placement"] = [0, 0, 1, 1]
        doc["host_health"] = [
            {"host": 0, "state": "healthy", "score": 0, "signals": [],
             "excluded": False},
            {"host": 1, "state": "degraded", "score": 55,
             "signals": ["beat_slow"], "excluded": False}]
    return doc


VARIANTS = ["plain", "no_rdv", "local", "aborted", "sdc", "no_tid",
            "unknown_slot", "straggling_absent"]


@pytest.mark.parametrize("name", VARIANTS)
def test_verdict_lines_match_reference(name):
    """``verdict`` gives the reference's lines on the same document, for
    every branch: the absent rank by global rank, the fence and
    local-compute fallbacks, the abort line, the SDC verdict, a capture
    with no trace id, an unknown slot, the straggler context."""
    doc = _variant(name)
    lines = port_doctor.verdict(doc)
    assert lines == ref_doctor.verdict(doc)
    text = "\n".join(lines)
    if name in ("plain", "aborted", "sdc", "no_tid"):
        assert "ABSENT ranks [6]" in text and "waiting ranks [4,5,7]" in text
        assert "cid=1" in text and "gen=3" in text
        assert "fence f1" in text and "VERDICT: in-flight KV" not in text
    if name == "plain":
        assert "0x9" in text and "s5" in text and "900ms" in text
    if name == "no_rdv":
        assert "VERDICT: in-flight KV fence(s)" in text
    if name == "local":
        assert "slow inside local compute" in text
    if name == "aborted":
        assert "aborted ranks [2, 1, 'boom']" in text
    if name == "sdc":
        assert "CONVICTED: rank 1 on host 0" in text
    if name == "unknown_slot":
        assert "ABSENT ranks [6,?9]" in text
    if name == "straggling_absent":
        assert "STRAGGLING" in text and "host 1 is degraded" in text


@pytest.mark.parametrize("last", [0, 1, 8])
def test_stack_and_event_lines_match_reference(last):
    doc = _capture_doc()
    doc["events"] = doc["events"] * 3
    assert port_doctor.stack_lines(doc) == ref_doctor.stack_lines(doc)
    assert port_doctor.event_lines(doc, last) == \
        ref_doctor.event_lines(doc, last)


def test_doctor_load_captures_and_cli(tmp_path, capsys):
    """A direct capture path and a uri file's siblings both load; the
    CLI prints the reference's output, filters by ``--job`` and prints
    the stacks; a mismatching job exits 1 with the hint."""
    uri = str(tmp_path / "pool.uri")
    cap = f"{uri}.doctor.s5.json"
    with open(cap, "w") as fh:
        json.dump(_capture_doc(), fh)
    with open(f"{uri}.doctor.s2.json", "w") as fh:
        json.dump(_capture_doc(sid=2, tid=0x8), fh)
    assert port_doctor.load_captures(cap)[0]["sid"] == 5
    assert [d["sid"] for d in port_doctor.load_captures(uri)] == [2, 5]
    for argv in ([uri], [cap], [uri, "--job", "0x9", "--stacks"],
                 [uri, "--events", "0"], [uri, "--job", "8"]):
        assert port_doctor.main(argv) == 0
        port_out = capsys.readouterr().out
        assert ref_doctor.main(argv) == 0
        assert port_out == capsys.readouterr().out
    assert port_doctor.main([uri, "--job", "0x9", "--stacks"]) == 0
    out = capsys.readouterr().out
    assert "dvm-s5-r0" in out and "ABSENT ranks [6]" in out
    assert "s2" not in out.split("\n")[0]
    assert port_doctor.main([uri, "--job", "0x7"]) == 1
    assert "obs_watchdog_ms" in capsys.readouterr().err
    assert port_doctor.main([str(tmp_path / "none")]) == 1


# -- the meeting's snapshot ---------------------------------------------------

@pytest.mark.parametrize("pattern", [(), (0,), (1, 3), (3, 0, 2),
                                     (0, 1, 2, 3)],
                         ids=["idle", "one", "two", "three", "full"])
def test_rendezvous_snapshot_matches_reference(pattern):
    """The same arrival pattern at a 4-member meeting of each package
    gives the same snapshot: size, generation, count, who arrived, who
    is absent and the generations whose results wait for readers (a
    full meeting has run and awaits its four readers)."""
    snaps = []
    for mod in (port_device, ref_device):
        rv = mod.Rendezvous(4)
        for r in pattern:
            rv.begin(r, r, lambda slots: list(slots))
        snaps.append(rv.snapshot())
        if len(pattern) == 4:
            for r in range(4):
                rv.finish(r, 0)
            snaps.append(rv.snapshot())
    assert snaps[:len(snaps) // 2] == snaps[len(snaps) // 2:]
    s = snaps[0]
    assert s["arrived"] == ([] if len(pattern) == 4 else sorted(pattern))
    assert s["count"] == len(pattern) % 4
    assert s["pending_gens"] == ([0] if len(pattern) == 4 else [])


def test_snapshot_reads_without_the_lock_when_it_is_held():
    """A wedged meeting may hold its lock: the snapshot waits at most
    0.2 s for it, then reads without it."""
    rv = port_device.Rendezvous(3)
    rv.begin(1, "x", lambda slots: list(slots))
    holding, release = threading.Event(), threading.Event()

    def hold():
        with rv.cv:  # another thread: the meeting's lock is reentrant
            holding.set()
            release.wait(10)

    th = threading.Thread(target=hold, daemon=True)
    th.start()
    holding.wait(10)
    t0 = time.monotonic()
    snap = rv.snapshot()
    took = time.monotonic() - t0
    release.set()
    th.join(10)
    assert snap["arrived"] == [1] and snap["absent"] == [0, 2]
    assert 0.15 <= took < 2.0


# -- the rdv_sever injector ------------------------------------------------------

@pytest.mark.parametrize("spec,victim,count",
                         [("rdv_sever:3", "1", 3), ("rdv_sever", "1", 8),
                          ("rdv_sever:1", "0,2", 1)],
                         ids=["third", "default", "two_victims"])
def test_rdv_sever_injector_matches_reference(spec, victim, count):
    """Armed only on the victim ranks, it fires exactly once, at the
    armed meeting count (8 for a bare class), as the reference's does;
    firing records one ft_inject event (rdv_sever, coll) for the rank."""
    with knobs({"ft_inject_plan": spec, "ft_inject_victim_rank": victim}):
        victims = [int(v) for v in victim.split(",")]
        for r in range(4):
            p = port_fi.rdv_sever_injector(r, 4)
            q = ref_fi.rdv_sever_injector(r, 4)
            assert (p is None) == (q is None) == (r not in victims)
            if p is None:
                continue
            rec = obs.recorder()
            h0 = rec.recorded
            fired_p = [p.should_sever() for _ in range(12)]
            fired_q = [q.should_sever() for _ in range(12)]
            assert fired_p == fired_q
            assert fired_p.index(True) == count - 1 and sum(fired_p) == 1
            evs = rec.snapshot(last=rec.recorded - h0)
            assert [(e["name"], e["args"], e["rank"]) for e in evs] == [
                ("ft_inject", {"cls": "rdv_sever", "scope": "coll"}, r)]


# -- the live wedge: capture, verdict, poison --------------------------------------

SEVER = {"ft_inject_plan": "rdv_sever:1", "ft_inject_victim_rank": "2",
         "coll_device_rendezvous_timeout": 60.0}


@pytest.mark.parametrize("tier", ["hbm", "mesh"])
def test_rdv_sever_wedge_is_diagnosed_and_unwinds(tier, tmp_path, capsys):
    """Rank 2 of 4 wedges short of its first deposit; a watcher thread
    builds the capture once ranks 0, 1 and 3 have arrived: the
    rendezvous row names rank 2 absent, every rank's stack is there,
    the health rows and the placement ride along, and the verdict (the
    reference's lines too) is the absent-rank one.  The CLI prints it
    from the file.  Poisoning the world unwinds every rank, the wedged
    one included, in well under the 60 s rendezvous timeout."""
    n = 4
    dmap = (lambda r: CPU) if tier == "hbm" else logical_devices("cpu")
    held = {}
    got = {}

    def fn(comm):
        comm.state.rte.node_id = comm.rank // 2
        if comm.rank == 0:
            held["world"] = comm.state.rte.world
        x = torch.arange(1024, dtype=torch.float32) + comm.rank
        return convert.to_numpy(comm.allreduce_arr(
            convert.to_torch(convert.to_numpy(x), comm.device),
            port_op.SUM))

    hp = port_health.HealthPlane(2, expect_beat_ns=100 * MS,
                                 floor_grace_ns=1000 * MS)

    def watcher():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            w = held.get("world")
            if w is not None:
                with w.shared_lock:
                    rvs = [v for k, v in w.shared.items()
                           if isinstance(k, tuple) and k[0] == "coll_rv"]
                if any(rv.snapshot()["count"] == 3 for rv in rvs):
                    time.sleep(0.3)  # the wedge is live, not a race
                    got["doc"] = sessions.doctor_capture(
                        w, sid=7, tid=0x1234, run_ms=300, est_ms=10,
                        factor_pct=400, health=hp)
                    got["t"] = time.monotonic()
                    sessions.poison(w, 3, "hang doctor")
                    return
            time.sleep(0.01)

    th = threading.Thread(target=watcher, daemon=True)
    with knobs(SEVER):
        th.start()
        with pytest.raises(RankError, match="aborted"):
            run_ranks(n, fn, device_map=dmap, timeout=60)
        unwound = time.monotonic()
    th.join(5)
    doc = got["doc"]
    assert unwound - got["t"] < 5.0
    assert doc["np"] == n and doc["placement"] == [0, 0, 1, 1]
    assert doc["aborted"] is None and doc["fences"] == {}
    assert [r["host"] for r in doc["host_health"]] == [0, 1]
    assert sorted(doc["stacks"]) == [f"mpi-rank-{r}" for r in range(n)]
    (rv,) = doc["rendezvous"]
    assert rv["arrived"] == [0, 1, 3] and rv["absent"] == [2]
    assert rv["count"] == 3 and rv["size"] == n
    assert rv["group"] == list(range(n))
    assert any(e["name"] == "ft_inject" and e["args"]["cls"] == "rdv_sever"
               for e in doc["events"])
    lines = port_doctor.verdict(doc)
    assert lines == ref_doctor.verdict(doc)
    text = "\n".join(lines)
    assert "ABSENT ranks [2]" in text and "waiting ranks [0,1,3]" in text
    assert "job 0x1234" in text
    path = tmp_path / "cap.json"
    path.write_text(json.dumps(doc))
    assert port_doctor.main([str(path), "--events", "4"]) == 0
    assert "ABSENT ranks [2]" in capsys.readouterr().out


def _session_one(comm, release):
    """World 1 of the two-world capture: rank 2 stays away from the
    meeting until released, the others wait in it."""
    if comm.rank == 2:
        release.wait(30)
    x = torch.arange(256, dtype=torch.float32, device=comm.device)
    return comm.allreduce_arr(x, port_op.SUM)


def _session_two(comm, release, parked):
    """World 2: every rank parks outside any meeting until released."""
    with parked[0]:
        parked[1] += 1
    release.wait(30)
    return comm.rank


def test_capture_reads_only_its_own_worlds_threads():
    """Two worlds of 4 rank threads run at once (``run_sessions``), so
    both name their threads mpi-rank-0..3; only world 1 is wedged.  Its
    capture holds world 1's four stacks and none of world 2's, and its
    one rendezvous row names rank 2 absent; world 2's capture holds its
    own stacks and no rendezvous.  Poisoning world 1 unwinds it while
    world 2 ends normally."""
    release1, release2 = threading.Event(), threading.Event()
    parked = [threading.Lock(), 0]
    held, got = {}, {}

    def fn(comm):
        if comm.rank == 0:
            held[comm.state.cid_band] = comm.state.rte.world
        if comm.state.cid_band == 1:
            return _session_one(comm, release1)
        return _session_two(comm, release2, parked)

    def watcher():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            w1, w2 = held.get(1), held.get(2)
            if w1 is not None and w2 is not None and parked[1] == 4:
                with w1.shared_lock:
                    rvs = [v for k, v in w1.shared.items()
                           if isinstance(k, tuple) and k[0] == "coll_rv"]
                if any(rv.snapshot()["count"] == 3 for rv in rvs):
                    got[1] = sessions.doctor_capture(w1, sid=1)
                    got[2] = sessions.doctor_capture(w2, sid=2)
                    sessions.poison(w1, 3, "hang doctor")
                    release1.set()
                    release2.set()
                    return
            time.sleep(0.01)
        release1.set()
        release2.set()

    th = threading.Thread(target=watcher, daemon=True)
    th.start()
    with pytest.raises(RankError, match="aborted"):
        sessions.run_sessions(2, 4, fn, device_map=lambda r: CPU,
                              timeout=60)
    th.join(5)
    one, two = got[1], got[2]
    names = [f"mpi-rank-{r}" for r in range(4)]
    assert sorted(one["stacks"]) == sorted(two["stacks"]) == names
    for st in one["stacks"].values():
        text = "".join(st)
        assert "_session_one" in text and "_session_two" not in text
    for st in two["stacks"].values():
        text = "".join(st)
        assert "_session_two" in text and "_session_one" not in text
    (rv,) = one["rendezvous"]
    assert rv["arrived"] == [0, 1, 3] and rv["absent"] == [2]
    assert two["rendezvous"] == []
    assert "ABSENT ranks [2]" in "\n".join(port_doctor.verdict(one))


def test_sever_hold_raises_at_the_rendezvous_timeout():
    """With no doctor and no abort, the wedge raises at the rendezvous
    timeout instead of hanging (the reference's message)."""
    with knobs({"coll_device_rendezvous_timeout": 0.1}):
        t0 = time.monotonic()
        with pytest.raises(RuntimeError, match="outlived the rendezvous"):
            port_device._sever_hold(lambda: None)
        assert time.monotonic() - t0 < 2.0


def test_poison_unwinds_every_rank_and_spares_none():
    """``poison`` aborts as rank -1, so every rank's own abort check
    fires (the world's aborter is exempt from its own), and parked
    ranks are woken."""
    def fn(comm):
        if comm.rank == 0:
            sessions.poison(comm.state.rte.world, 5, "test")
        comm.Barrier()
        return None

    with pytest.raises(RankError, match="aborted"):
        run_ranks(3, fn, timeout=30)
