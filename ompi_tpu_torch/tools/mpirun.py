"""mpirun: launch N ranks with KV wireup, IO forwarding and failure
propagation — single-host directly, multi-host through per-node
daemons.

Port of the reference's tools/mpirun.py, a re-design of orterun/HNP
(ref: orte/tools/orterun/main.c:13, orted_submit.c job construction;
odls fork/exec ref: odls_default_module.c:338-437; IOF ref:
orte/mca/iof; errmgr default-HNP kill-job-on-proc-death policy ref:
orte/mca/errmgr/default_hnp).  The launch lifecycle is an
EVENT-DRIVEN STATE MACHINE (runtime/statemachine.py — the
orte/mca/state analog, ref: state.h:92-109, state_base_fns.c:428-843):

    INIT -> ALLOCATE -> MAP -> [LAUNCH_DAEMONS -> DAEMONS_REPORTED]
         -> LAUNCH_APPS -> RUNNING -> DRAINING -> TERMINATED

Daemon report-ins, proc exits, node completions, KV aborts and
timeouts arrive as events from any thread; the errmgr policy (first
abnormal exit / daemon loss / abort kills the job) is implemented as
the PROC_FAILED / DAEMON_FAILED / ABORTED / TIMEOUT state handlers.
``--verbose state`` traces every transition.

On the default single-local-node allocation the launcher IS the
daemon: it fork/execs each rank (or, with --ranks-per-proc, each app
shell, tools/hostrun.py) with subprocess.Popen, daemon states
skipped.  With --hosts/--hostfile/--simulate-nodes the PLM takes
over: a radix tree of tpud daemons is launched (ssh agent or local
subprocesses), each daemon runs its slice of the rmaps job map and
relays IOF/exits back (tools/plm.py, tools/tpud.py).  Neither this
module nor the daemons import anything that initialises a card, so
no child inherits a CUDA context.  A simulated node's app shell gives
its ranks M devices of their own (tools/hostrun.py).  ``--dvm
URI_FILE`` launches nothing: it submits the program to a running
resident pool (tools/dvm.py ``submit``), whose devices were fixed when
it started.  Not ported yet, raising NotImplementedError that names
its ROADMAP item: --ckpt-dir / --restart (cr/ckpt.py, A9).

Usage:
    python -m ompi_tpu_torch.tools.mpirun -np 4 [--mca k v] [--tag-output]
        [--timeout SEC] [--verbose state] [--hosts a,b:4 |
        --hostfile F | --simulate-nodes NxM] [--map-by byslot|bynode]
        [--ranks-per-proc N|all] [--devices auto|cpu|none]
        [--bind-to none|core|numa] prog [args...]
"""

from __future__ import annotations

import argparse
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch.mca.params import registry as _params
from ompi_tpu_torch.runtime import statemachine as smx
from ompi_tpu_torch.runtime.kvstore import KVServer

_errmgr_policy_var = _params.register(
    "errmgr", "base", "policy", "abort", str,
    help="What the launcher does when a proc/daemon fails: 'abort' "
         "(first failure kills the job — the errmgr/default_hnp "
         "policy), 'restart' (with --ckpt-dir, which the port does "
         "not have yet: relaunch the WHOLE "
         "job from the latest complete snapshot), or 'recover' "
         "(with --ckpt-dir: on daemon loss, remap the dead node's "
         "ranks onto a survivor at a bumped recovery epoch while "
         "the job keeps running — live re-route, runtime/ft.py; "
         "ref: rmaps_resilient.c:76+, routed_radix.c:58 and "
         "orte/mca/rmaps/resilient/rmaps_resilient.c), or 'ulfm' "
         "(forward recovery, ompi_tpu_torch/ft/ulfm: a dead rank becomes a "
         "job-wide failure record; survivors get ERR_PROC_FAILED and "
         "continue via Comm.revoke/agree/shrink — no restart, no "
         "rollback), or 'respawn' (self-healing, ompi_tpu_torch/ft/respawn: "
         "the dead rank is relaunched IN-JOB under its original world "
         "rank at a bumped recovery epoch; survivors and the "
         "replacement run the rejoin protocol and restore from buddy "
         "checkpoints — the job finishes at full size)")
_errmgr_max_restarts_var = _params.register(
    "errmgr", "base", "max_restarts", 2, int,
    help="Automatic relaunch attempts before giving up (restart "
         "policy: whole-job relaunches; respawn policy: per-rank "
         "replacements)")


def _forward(stream, out, tag: str, tag_output: bool) -> None:
    """IOF: line-buffered forwarding with optional rank tags
    (ref: orte/mca/iof flow)."""
    try:
        for line in iter(stream.readline, b""):
            if tag_output:
                out.write(f"[{tag}]".encode() + line)
            else:
                out.write(line)
            out.flush()
    except (OSError, ValueError):
        pass


def _pkg_root() -> str:
    import ompi_tpu_torch as _pkg
    return os.path.dirname(os.path.dirname(os.path.abspath(
        _pkg.__file__)))


def _ulfm_publish_failed(server: KVServer, ranks,
                         epoch: Optional[int] = None) -> None:
    """Append job-wide ULFM failure records (``ulfm:note:<n>``) for
    dead ranks; every surviving rank's ulfm watcher consumes them in
    order.  Written under the server lock so getters blocked on the
    next note wake through the server's condition variable.  The
    respawn policy passes ``epoch`` — the recovery epoch this failure
    opens — so the note stream stays replayable: a late watcher (or a
    respawned rank's own) filters recovered deaths by epoch instead of
    re-killing a revived rank (ft/ulfm._ingest)."""
    with server.cv:
        n = server.counters.get("ulfm:nseq", 0)
        for r in ranks:
            rec = ["fail", int(r)] if epoch is None \
                else ["fail", int(r), int(epoch)]
            server.data[f"ulfm:note:{n}"] = rec
            n += 1
        server.counters["ulfm:nseq"] = n
        server.cv.notify_all()


def _tag_ranks(tag: str) -> List[int]:
    """Global ranks named by a launch-unit tag ('3', '4-7', or the
    multinode 'node:3' / 'node:4-7' forms)."""
    tag = tag.rsplit(":", 1)[-1]
    try:
        if "-" in tag:
            lo, hi = tag.split("-", 1)
            return list(range(int(lo), int(hi) + 1))
        return [int(tag)]
    except ValueError:
        return []


def _wire_abort(server: KVServer, sm: smx.StateMachine) -> None:
    server.on_abort = lambda ab: sm.activate(
        smx.ABORTED, rank=ab[0], code=ab[1], msg=ab[2])


def _errmgr_table(sm: smx.StateMachine, drain) -> None:
    """The errmgr/default_hnp policy as state handlers: any failure
    state drains the job with a diagnostic; DRAINING is idempotent.
    Failures also route to the admin notifier sinks (orte/mca/notifier
    analog; off unless --mca orte_notifier_sinks is set)."""
    from ompi_tpu_torch.runtime.notifier import notify as _notify
    _job = f"job-{os.getpid()}"

    def _already_drained(sm) -> bool:
        # a late failure/timeout event must never rewrite the exit
        # code of a job that already drained cleanly
        return bool(sm.data.get("drained"))

    def on_proc_failed(sm, info):
        if _already_drained(sm):
            return
        code = info["code"] if info["code"] > 0 else 1
        extra = f" ({info['error']})" if info.get("error") else ""
        sys.stderr.write(
            f"mpirun: {info['who']} exited with status "
            f"{info['code']}{extra}; terminating job\n")
        _notify("error", _job,
                f"{info['who']} exited with status {info['code']}")
        sm.exit_code = code
        sm.activate(smx.DRAINING, failed=True)

    def on_daemon_failed(sm, info):
        if _already_drained(sm):
            return
        sys.stderr.write(
            f"mpirun: lost contact with daemon on node(s) "
            f"[{info['node']}]; terminating job\n")
        _notify("crit", _job, f"daemon lost on node {info['node']}")
        sm.exit_code = 1
        sm.activate(smx.DRAINING, failed=True)

    def on_aborted(sm, info):
        if _already_drained(sm):
            return
        sm.exit_code = info["code"] or 1
        sys.stderr.write(
            f"mpirun: rank {info['rank']} called "
            f"MPI_Abort({sm.exit_code}): {info['msg']}\n")
        _notify("error", _job,
                f"rank {info['rank']} called MPI_Abort")
        sm.activate(smx.DRAINING, failed=True)

    def on_timeout(sm, info):
        if _already_drained(sm):
            return
        sys.stderr.write("mpirun: job exceeded --timeout; killing\n")
        _notify("warn", _job, "job exceeded --timeout")
        sm.exit_code = 124
        sm.activate(smx.DRAINING, failed=True)

    def on_launch_failed(sm, info):
        if _already_drained(sm):
            return
        if info.get("msg"):
            sys.stderr.write(f"mpirun: {info['msg']}\n")
        sm.exit_code = info.get("code", 1)
        sm.activate(smx.DRAINING, failed=True)

    def on_draining(sm, info):
        if not sm.data.get("drained"):
            sm.data["drained"] = True
            drain(info.get("failed", False))
        sm.activate(smx.TERMINATED)

    sm.register_table({
        smx.PROC_FAILED: on_proc_failed,
        smx.DAEMON_FAILED: on_daemon_failed,
        smx.ABORTED: on_aborted,
        smx.TIMEOUT: on_timeout,
        smx.LAUNCH_FAILED: on_launch_failed,
        smx.DRAINING: on_draining,
        smx.TERMINATED: lambda sm, info: None,
        smx.RUNNING: lambda sm, info: None,
    })


def run_multinode(opts, nodes, rpp: int, hybrid: bool,
                  ckpt_env: dict) -> int:
    """The PLM path: per-node daemons, rmaps job map, tree launch —
    sequenced by the hnp-role state machine."""
    from ompi_tpu_torch.runtime import oob, rmaps
    from ompi_tpu_torch.tools.plm import HNP

    sm = smx.StateMachine("hnp", verbose="state" in opts.verbose.split(","))
    d = sm.data
    d.update(registered=set(), done=set(), drained=False)

    pkg_root = _pkg_root()

    def on_allocate(sm, info):
        # allocation itself happened in main() (ras.allocate); this
        # state validates and records it
        d["nodes"] = nodes
        sm.activate(smx.MAP)

    def on_map(sm, info):
        try:
            d["maps"] = rmaps.map_ranks(
                nodes, opts.np, rpp if hybrid else 1,
                policy=opts.map_by, oversubscribe=opts.oversubscribe)
        except ValueError as e:
            sm.activate(smx.LAUNCH_FAILED, msg=str(e), code=2)
            return
        sm.activate(smx.LAUNCH_DAEMONS)

    def on_launch_daemons(sm, info):
        maps = d["maps"]
        any_remote = any(not (n.simulated or n.local) for n in nodes)
        if any_remote:
            hnp_ip = opts.hnp_ip or oob.local_ip_toward(
                next(n.name for n in nodes
                     if not (n.simulated or n.local)) + ":22")
        else:
            hnp_ip = "127.0.0.1"
        server = KVServer(opts.np,
                          host="0.0.0.0" if any_remote else "127.0.0.1",
                          advertise=hnp_ip if any_remote else None)
        _wire_abort(server, sm)
        hnp = HNP(maps, agent=opts.agent, python=sys.executable,
                  pythonpath=pkg_root, tree_radix=opts.tree_radix,
                  bind_all=any_remote, events=sm)
        hnp.tag_output = opts.tag_output
        d.update(server=server, hnp=hnp,
                 want={m.node.node_id for m in maps},
                 active={m.node.node_id for m in maps if m.procs})

        # per-node daemon env: a simulated node's app shell gives its
        # ranks M devices of its own (ras/simulator analog; the
        # reference forces an M-device CPU platform, the port hands
        # out M logical devices — tools/hostrun.py shell_devices).
        # MCA env reaches the DAEMONS too — heartbeat, oob retry and
        # ft_inject knobs are read by tpud itself, not only by ranks
        mca_env = {
            **{k: v for k, v in os.environ.items()
               if k.startswith(("TPUMPI_MCA_", "OMPI_MCA_"))},
            **{f"TPUMPI_MCA_{k}": v for k, v in opts.mca},
        }
        node_env = {}
        for n in nodes:
            env = {"TPUMPI_JOB_SECRET":
                   os.environ["TPUMPI_JOB_SECRET"],
                   **mca_env}
            if n.simulated and opts.devices != "none":
                env["TPUMPI_SIM_NODES"] = str(len(nodes))
                env["TPUMPI_SIM_DEVICES"] = str(n.sim_devices)
            node_env[n.node_id] = env

        job_env = {
            # MCA environment forwards to remote ranks (the schizo
            # discipline: reference users' OMPI_MCA_* env applies
            # job-wide, not just on the mpirun host); explicit --mca
            # pairs below still win
            **{k: v for k, v in os.environ.items()
               if k.startswith(("TPUMPI_MCA_", "OMPI_MCA_"))},
            **ckpt_env,
            "TPUMPI_BIND": opts.bind_to,
            "TPUMPI_SIZE": str(opts.np),
            "TPUMPI_KV_ADDR": server.uri,
            "TPUMPI_JOBID": f"job-{os.getpid()}",
            "TPUMPI_JOB_SECRET": os.environ["TPUMPI_JOB_SECRET"],
        }
        if _errmgr_policy_var.value in ("ulfm", "respawn"):
            # ranks start the ulfm note watcher (ompi_tpu_torch/ft/ulfm);
            # respawn rides the same detection plane.  The value names
            # the policy: an app shell handles a rank-thread's death
            # by it (tools/hostrun)
            job_env["TPUMPI_ULFM"] = _errmgr_policy_var.value
        if hybrid:
            job_env["TPUMPI_DEVICES"] = opts.devices
        for key, value in opts.mca:
            job_env[f"TPUMPI_MCA_{key}"] = value
        d["job_env"] = job_env

        hnp.spawn_daemons(hnp_ip, node_env)
        t = threading.Timer(max(90.0, opts.timeout),
                            lambda: sm.activate("EV_REG_TIMEOUT"))
        t.daemon = True
        t.start()
        d["reg_timer"] = t

    def ev_daemon_up(sm, info):
        d["registered"].add(info["node"])
        if sm.state == smx.LAUNCH_DAEMONS \
                and d["registered"] >= d["want"]:
            sm.activate(smx.DAEMONS_REPORTED)

    def ev_reg_timeout(sm, info):
        if sm.state == smx.LAUNCH_DAEMONS:
            missing = d["want"] - d["registered"]
            sm.activate(
                smx.LAUNCH_FAILED, code=1,
                msg=f"daemons on node(s) {sorted(missing)} never "
                    f"registered")

    def ev_conn_lost(sm, info):
        # a connection died before registering: fatal during launch,
        # a stray probe once running
        if sm.state == smx.LAUNCH_DAEMONS:
            sm.activate(smx.LAUNCH_FAILED, code=1,
                        msg="daemon connection lost before "
                            "registration")

    def ev_daemon_lost(sm, info):
        if info["node"] in d["done"] or d.get("drained") \
                or sm.state in (smx.DRAINING, smx.TERMINATED):
            return  # clean teardown closes daemon channels
        if sm.state == smx.RUNNING \
                and _errmgr_policy_var.value == "ulfm" \
                and try_ulfm_node(sm, info["node"]):
            return  # survivors continue with ERR_PROC_FAILED
        sm.activate(smx.DAEMON_FAILED, node=info["node"])

    def try_ulfm_node(sm, node: int) -> bool:
        """ULFM forward recovery on daemon loss: declare every rank
        the dead node hosted permanently failed (one note each) and
        keep the job running — survivors shrink around the hole."""
        failed = next((m for m in d["maps"]
                       if m.node.node_id == node and m.procs), None)
        if failed is None:
            return False
        ranks: List[int] = []
        for p in failed.procs:
            ranks += list(range(p.rank_base,
                                p.rank_base + max(1, p.nlocal)))
        _ulfm_publish_failed(d["server"], ranks)
        d["done"].add(node)  # the node will never report node_done
        # one atomic domain record: the whole host's rank set failed
        # together, not N racing per-rank detections
        _obs.record_event(_obs.EV_HOST_LOST, node, len(ranks), 1)
        sys.stderr.write(
            f"mpirun: daemon on node {node} lost; ulfm policy: "
            f"ranks {ranks} declared failed, job continues on "
            f"survivors\n")
        if d["active"] <= d["done"]:
            sm.activate(smx.DRAINING, failed=False)
        return True

    def on_daemons_reported(sm, info):
        d["reg_timer"].cancel()
        sm.activate(smx.LAUNCH_APPS)

    def on_launch_apps(sm, info):
        prog = os.path.abspath(opts.prog) if os.path.exists(opts.prog) \
            else opts.prog
        if opts.preload and not os.path.isfile(prog):
            sm.activate(smx.LAUNCH_FAILED, code=2,
                        msg=f"--preload: cannot read program "
                            f"{opts.prog!r}")
            return
        d["launched_prog"] = prog
        if opts.preload and os.path.isfile(prog) \
                and _errmgr_policy_var.value == "respawn":
            # only the respawn policy ever relaunches from d;
            # the normal path lets HNP.launch do its own encode
            import base64 as _b64
            with open(prog, "rb") as _fh:
                d["prog_data"] = _b64.b64encode(
                    _fh.read()).decode("ascii")
        d["hnp"].launch(prog, opts.args, d["job_env"], opts.wdir,
                        preload=opts.preload)
        sm.activate(smx.RUNNING)

    def try_respawn_remote(info) -> bool:
        """Respawn policy on the PLM path: relaunch the dead launch
        unit on ITS OWN node (the daemon survived — only the rank
        process died; daemon loss still falls through to the ulfm/
        abort ladder in ev_daemon_lost)."""
        tag = info.get("tag", "")
        ranks = _tag_ranks(tag)
        if not ranks:
            return False
        node = None
        unit = None
        for m in d["maps"]:
            for p in m.procs:
                lo = p.rank_base
                hi = lo + max(1, p.nlocal)
                if lo <= ranks[0] < hi:
                    node, unit = m.node.node_id, p
                    break
            if unit is not None:
                break
        if unit is None:
            return False
        tries = d.setdefault("respawns", {}).get(tag, 0)
        max_r = int(_errmgr_max_restarts_var.value)
        if tries >= max_r:
            sys.stderr.write(
                f"mpirun: {info['tag']} died again but reached "
                f"errmgr_base_max_restarts={max_r}; giving up\n")
            return False
        d["respawns"][tag] = tries + 1
        epoch = d["ft_epoch"] = d.get("ft_epoch", 0) + 1
        # note first, replacement second (same ordering argument as
        # the local path): survivors must see the death before the
        # newcomer's init fences can find partners
        _ulfm_publish_failed(d["server"], ranks, epoch)
        env = dict(d["job_env"])
        env["TPUMPI_FT_EPOCH"] = str(epoch)
        env["TPUMPI_RESPAWN"] = "1"
        try:
            d["hnp"].send_launch(node, {
                "op": "launch", "prog": d["launched_prog"],
                "args": opts.args, "prog_data": d.get("prog_data"),
                "wdir": opts.wdir, "env": env,
                "procs": [{"rank_base": unit.rank_base,
                           "nlocal": unit.nlocal}],
            })
        except (KeyError, ConnectionError, OSError) as e:
            sys.stderr.write(
                f"mpirun: respawn policy: relaunch of {tag} on node "
                f"{node} failed ({e}); tearing down\n")
            return False
        sys.stderr.write(
            f"mpirun: {info['tag']} exited with status "
            f"{info['code']}; respawn policy: relaunching on node "
            f"{node} at epoch {epoch} (attempt {tries + 1}/{max_r})\n")
        return True

    def ev_proc_exit(sm, info):  # only abnormal exits are posted
        if d.get("drained"):
            return
        if sm.state == smx.RUNNING \
                and _errmgr_policy_var.value == "respawn" \
                and try_respawn_remote(info):
            return
        if sm.state == smx.RUNNING \
                and _errmgr_policy_var.value == "ulfm":
            ranks = _tag_ranks(info["tag"])
            if ranks:
                _ulfm_publish_failed(d["server"], ranks)
                sys.stderr.write(
                    f"mpirun: {info['tag']} exited with status "
                    f"{info['code']}; ulfm policy: ranks {ranks} "
                    f"declared failed, job continues on survivors\n")
                return
        sm.activate(smx.PROC_FAILED, who=info["tag"],
                    code=info["code"], error=info.get("error", ""))

    def ev_node_done(sm, info):
        d["done"].add(info["node"])
        if sm.state in (smx.RUNNING, smx.LAUNCH_APPS) \
                and d["active"] <= d["done"]:
            sm.activate(smx.DRAINING, failed=False)

    def drain(failed: bool) -> None:
        hnp = d.get("hnp")
        server = d.get("server")
        if server is not None and "kv" in opts.verbose.split(","):
            sys.stderr.write(
                f"mpirun: kv server served "
                f"{server.connections_served} connections\n")
        if "reg_timer" in d:
            d["reg_timer"].cancel()
        if hnp is not None:
            hnp.shutdown(failed)
        if server is not None:
            server.close()

    sm.register_table({
        smx.ALLOCATE: on_allocate,
        smx.MAP: on_map,
        smx.LAUNCH_DAEMONS: on_launch_daemons,
        smx.DAEMONS_REPORTED: on_daemons_reported,
        smx.LAUNCH_APPS: on_launch_apps,
        "EV_DAEMON_UP": ev_daemon_up,
        "EV_REG_TIMEOUT": ev_reg_timeout,
        "EV_CONN_LOST": ev_conn_lost,
        "EV_DAEMON_LOST": ev_daemon_lost,
        "EV_PROC_EXIT": ev_proc_exit,
        "EV_NODE_DONE": ev_node_done,
    })
    _errmgr_table(sm, drain)
    sm.start_timeout(opts.timeout)
    sm.activate(smx.ALLOCATE)
    try:
        return sm.run()
    finally:
        if not d.get("drained"):
            drain(True)


def run_local(opts, rpp: int, hybrid: bool, ckpt_env: dict) -> int:
    """The direct fork/exec path (the launcher IS the daemon) —
    sequenced by the same state machine, daemon states skipped."""
    sm = smx.StateMachine("hnp", verbose="state" in opts.verbose.split(","))
    d = sm.data
    d.update(drained=False, outstanding=0)
    procs: List[subprocess.Popen] = []
    ptags: List[str] = []
    fwd_threads: List[threading.Thread] = []
    lock = threading.Lock()

    session = tempfile.mkdtemp(prefix="tpumpi-session-")
    server = KVServer(opts.np)
    _wire_abort(server, sm)

    pkg_root = _pkg_root()
    env_base = dict(os.environ)
    # children must see the ompi_tpu_torch package regardless of their cwd
    env_base["PYTHONPATH"] = pkg_root + (
        os.pathsep + env_base["PYTHONPATH"]
        if env_base.get("PYTHONPATH") else "")
    env_base.update(ckpt_env)
    env_base.update({
        "TPUMPI_BIND": opts.bind_to,
        "TPUMPI_SIZE": str(opts.np),
        "TPUMPI_LOCAL_SIZE": str(opts.np),  # single-host launch
        "TPUMPI_KV_ADDR": server.uri,
        "TPUMPI_SESSION_DIR": session,
        "TPUMPI_JOBID": f"job-{os.getpid()}",
    })
    for key, value in opts.mca:
        env_base[f"TPUMPI_MCA_{key}"] = value
    if _errmgr_policy_var.value in ("ulfm", "respawn"):
        # ranks start the ulfm note watcher (ompi_tpu_torch/ft/ulfm);
        # respawn rides the same detection plane.  The value names the
        # policy: an app shell handles a rank-thread's death by it
        # (tools/hostrun)
        env_base["TPUMPI_ULFM"] = _errmgr_policy_var.value

    def _write_proctable() -> None:
        """MPIR proctable analog (ref: ompi/debuggers MPIR_proctable):
        rank(s) -> pid map for ompi_tpu_torch.tools.attach."""
        import json as _json
        import socket as _socket
        with lock:
            table = [{"tag": t, "pid": p.pid,
                      "host": _socket.gethostname()}
                     for t, p in zip(ptags, procs)
                     if p.poll() is None]
        try:
            with open(os.path.join(session, "proctable.json"),
                      "w") as fh:
                _json.dump(table, fh)
        except OSError:
            pass

    def spawn_proc(cmd, env, tag) -> None:
        """odls fork/exec + IOF wiring + an exit-reaper thread that
        posts EV_PROC_EXIT (replaces the 20 ms poll loop)."""
        p = subprocess.Popen(cmd, env=env, cwd=opts.wdir,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE)
        with lock:
            procs.append(p)
            ptags.append(tag)
            d["outstanding"] += 1
            # launch record per tag: the respawn policy relaunches the
            # exact unit that died (same cmd, env rebuilt per epoch)
            d.setdefault("launch_recs", {})[tag] = (list(cmd),
                                                    dict(env))
        for stream, out in ((p.stdout, sys.stdout.buffer),
                            (p.stderr, sys.stderr.buffer)):
            t = threading.Thread(
                target=_forward,
                args=(stream, out, tag, opts.tag_output), daemon=True)
            t.start()
            fwd_threads.append(t)

        def reap() -> None:
            code = p.wait()
            sm.activate("EV_PROC_EXIT", code=code, tag=tag,
                        who=f"rank {tag}"
                        if "-" not in tag else f"ranks {tag}")
        threading.Thread(target=reap, daemon=True).start()

    def on_launch_apps(sm, info):
        if opts.prog.endswith(".py"):
            base_cmd = [sys.executable, opts.prog] + opts.args
        else:
            base_cmd = [opts.prog] + opts.args
        # hybrid mode: one app-shell process per block of rpp ranks,
        # each running its ranks as threads (the TPU-host model)
        if hybrid:
            specs = []
            base = 0
            node = 0
            while base < opts.np:
                n = min(rpp, opts.np - base)
                specs.append((base, n, node))
                base += n
                node += 1
            env_base["TPUMPI_DEVICES"] = opts.devices
        else:
            specs = [(rank, 0, rank) for rank in range(opts.np)]
        for base, nlocal, node in specs:
            env = dict(env_base)
            if nlocal:  # app shell owning ranks [base, base+nlocal)
                env["TPUMPI_RANK_BASE"] = str(base)
                env["TPUMPI_NODE_RANK_BASE"] = "0"  # single node
                env["TPUMPI_LOCAL_RANKS"] = str(nlocal)
                env["TPUMPI_LOCAL_SIZE"] = str(nlocal)
                env["TPUMPI_NODE"] = str(node)
                cmd = [sys.executable, "-m",
                       "ompi_tpu_torch.tools.hostrun", opts.prog] + opts.args
                tag = f"{base}-{base + nlocal - 1}" if nlocal > 1 \
                    else f"{base}"
            else:
                env["TPUMPI_RANK"] = str(base)
                env["TPUMPI_LOCAL_RANK"] = str(base)  # single host
                cmd = base_cmd
                tag = f"{base}"
            spawn_proc(cmd, env, tag)
        _write_proctable()
        sm.activate(smx.RUNNING)

    def try_respawn(info) -> bool:
        """errmgr respawn policy (ompi_tpu_torch/ft/respawn): relaunch the
        dead unit IN-JOB under its original world rank(s).  The
        failure is published as an epoch-tagged ULFM note — survivors
        detect, run the rejoin protocol and meet the replacement's
        init fences at the bumped epoch; buddy checkpoints restore its
        state.  One failure event = one epoch (failures are handled
        one rejoin at a time — see ft/respawn.py)."""
        tag = info.get("tag", "")
        ranks = _tag_ranks(tag)
        with lock:
            rec = d.get("launch_recs", {}).get(tag)
        if not ranks or rec is None:
            return False
        tries = d.setdefault("respawns", {}).get(tag, 0)
        max_r = int(_errmgr_max_restarts_var.value)
        if tries >= max_r:
            sys.stderr.write(
                f"mpirun: {info['who']} died again but reached "
                f"errmgr_base_max_restarts={max_r}; giving up\n")
            return False
        d["respawns"][tag] = tries + 1
        epoch = d["ft_epoch"] = d.get("ft_epoch", 0) + 1
        # note first, replacement second: survivors must observe the
        # death (and start rejoining) before the newcomer can exist;
        # its init fences park on the epoch-scoped KV keys until the
        # survivors' rejoin fences arrive
        _ulfm_publish_failed(server, ranks, epoch)
        cmd, env = list(rec[0]), dict(rec[1])
        env["TPUMPI_FT_EPOCH"] = str(epoch)
        env["TPUMPI_RESPAWN"] = "1"
        sys.stderr.write(
            f"mpirun: {info['who']} exited with status "
            f"{info['code']}; respawn policy: relaunching under the "
            f"same rank(s) at epoch {epoch} "
            f"(attempt {tries + 1}/{max_r})\n")
        spawn_proc(cmd, env, tag)
        _write_proctable()
        return True

    def ev_proc_exit(sm, info):
        with lock:
            d["outstanding"] -= 1
            left = d["outstanding"]
            if info["code"] == 0:
                d["clean_exits"] = d.get("clean_exits", 0) + 1
        if d.get("drained") or sm.state in (smx.DRAINING,
                                            smx.TERMINATED):
            return
        if info["code"] != 0:
            if sm.state == smx.RUNNING \
                    and _errmgr_policy_var.value == "respawn" \
                    and try_respawn(info):
                return
            if sm.state == smx.RUNNING \
                    and _errmgr_policy_var.value == "ulfm":
                ranks = _tag_ranks(info.get("tag", ""))
                if ranks:
                    # ulfm policy: promote the dead ranks into
                    # job-wide failure records and keep running —
                    # survivors see ERR_PROC_FAILED and shrink
                    _ulfm_publish_failed(server, ranks)
                    sys.stderr.write(
                        f"mpirun: {info['who']} exited with status "
                        f"{info['code']}; ulfm policy: declared "
                        f"failed, job continues on survivors\n")
                    if left <= 0 and not d.get("clean_exits"):
                        # no survivor finished: the job failed as a
                        # whole (the reference exits 0 here)
                        sm.activate(smx.PROC_FAILED, who=info["who"],
                                    code=info["code"],
                                    error="no rank survived")
                    elif left <= 0:
                        sm.activate(smx.DRAINING, failed=False)
                    return
            # errmgr default-HNP policy: first abnormal exit kills
            # the job and its code is the job's code
            sm.activate(smx.PROC_FAILED, who=info["who"],
                        code=info["code"], error="")
        elif left <= 0:
            sm.activate(smx.DRAINING, failed=False)

    def drain(failed: bool) -> None:
        if failed:
            # diagnostic grace: the event-driven abort reaction is
            # near-instant, but peer shells may still be WRITING their
            # tracebacks — give them a beat before termination so the
            # IOF forwarders capture the actual failure, not just ours
            time.sleep(0.25)
        for p in procs:
            if p.poll() is None:
                p.terminate()
        t_end = time.monotonic() + 2.0
        for p in procs:
            if p.poll() is None and time.monotonic() < t_end:
                try:
                    p.wait(timeout=max(0.1, t_end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
        for p in procs:
            if p.poll() is None:
                p.kill()
        for t in fwd_threads:
            t.join(timeout=1.0)
        if "kv" in opts.verbose.split(","):
            sys.stderr.write(
                f"mpirun: kv server served "
                f"{server.connections_served} connections\n")
        server.close()
        shutil.rmtree(session, ignore_errors=True)

    sm.register_table({
        smx.ALLOCATE: lambda sm, info: sm.activate(smx.MAP),
        smx.MAP: lambda sm, info: sm.activate(smx.LAUNCH_APPS),
        smx.LAUNCH_APPS: on_launch_apps,
        "EV_PROC_EXIT": ev_proc_exit,
    })
    _errmgr_table(sm, drain)
    sm.start_timeout(opts.timeout)
    sm.activate(smx.ALLOCATE)
    try:
        return sm.run()
    finally:
        if not d.get("drained"):
            drain(True)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="mpirun")
    ap.add_argument("-np", "-n", type=int, required=True, dest="np")
    ap.add_argument("--mca", nargs=2, action="append", default=[],
                    metavar=("KEY", "VALUE"))
    ap.add_argument("--tag-output", action="store_true")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="Kill the job after SEC seconds")
    ap.add_argument("--verbose", default="", metavar="WHAT",
                    help="Comma list of subsystems to trace "
                         "('state': job state-machine transitions)")
    ap.add_argument("--wdir", default=None)
    def _rpp_arg(v: str):
        if v == "all":
            return v
        try:
            n = int(v)
        except ValueError:
            raise argparse.ArgumentTypeError(
                f"expected an integer or 'all', got {v!r}") from None
        if n < 1:
            raise argparse.ArgumentTypeError("must be >= 1")
        return n

    ap.add_argument("--ranks-per-proc", default=1, dest="rpp",
                    type=_rpp_arg,
                    help="Rank-threads per app-shell process: an int, "
                         "or 'all' for one process owning every rank "
                         "(required for the device collectives: ranks "
                         "meet inside one process)")
    ap.add_argument("--devices", default="auto",
                    choices=("auto", "cpu", "none"),
                    help="Devices of the rank-threads (hybrid mode "
                         "only): auto = the cards, rank r on card "
                         "r %% count (no card: the shell fails, no rank "
                         "starts); cpu = every rank on the CPU; none = "
                         "host-only ranks")
    ap.add_argument("--hosts", default=None,
                    help="Comma list of nodes, optional :slots "
                         "(a,b:4,c)")
    ap.add_argument("--hostfile", default=None,
                    help="File of 'name [slots=N]' lines")
    ap.add_argument("--simulate-nodes", default=None, dest="simulate",
                    help="NxM: fake N nodes with M slots each as local "
                         "daemons (the ras/simulator analog); a node's "
                         "app shell gives its ranks M devices: M "
                         "logical devices of card n %% count (M distinct "
                         "cards when the host has N x M), or of the CPU "
                         "with --devices cpu")
    ap.add_argument("--map-by", default="byslot", dest="map_by",
                    help="rmaps policy: byslot | bynode | ppr:N:node "
                         "| seq | rankfile:PATH")
    ap.add_argument("--oversubscribe", action="store_true")
    ap.add_argument("--launch-agent", default="ssh", dest="agent",
                    help="Remote daemon launcher (e.g. 'ssh' or "
                         "'python -m ompi_tpu_torch.tools.localssh')")
    ap.add_argument("--tree-radix", type=int, default=32,
                    help="PLM launch-tree fan-out per daemon")
    ap.add_argument("--preload", action="store_true",
                    help="Ship the program file to each node inside "
                         "the launch message (filem/raw analog: no "
                         "shared filesystem needed)")
    ap.add_argument("--bind-to", default="none", dest="bind_to",
                    choices=("none", "core", "numa"),
                    help="Bind each rank to a core / NUMA domain by "
                         "local rank (the rtc/hwloc binding analog)")
    ap.add_argument("--ckpt-dir", default=None, dest="ckpt_dir",
                    help="Checkpoint store root exported to ranks as "
                         "TPUMPI_CKPT_DIR (not ported yet, ROADMAP.md "
                         "A9: cr/ckpt.py)")
    ap.add_argument("--ckpt-keep", type=int, default=None,
                    dest="ckpt_keep", metavar="N",
                    help="Prune the checkpoint store to the newest N "
                         "complete snapshots (exports the cr_keep MCA "
                         "default job-wide; 0/default keeps all)")
    ap.add_argument("--restart", default=None, metavar="DIR",
                    help="Restart from the latest complete snapshot "
                         "in DIR (not ported yet, ROADMAP.md A9: "
                         "cr/ckpt.py)")
    ap.add_argument("--hnp-ip", default=None,
                    help="IP remote nodes should dial for the HNP "
                         "control + KV servers (default: auto-detect)")
    ap.add_argument("--dvm", default=None, metavar="URI_FILE",
                    help="submit the job to a running resident pool "
                         "(ompi_tpu_torch.tools.dvm) instead of "
                         "launching: the pool's CUDA context, kernel "
                         "libraries and imports carry across jobs "
                         "(orte-dvm analog)")
    ap.add_argument("prog")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    opts = ap.parse_args(argv)
    if opts.dvm:
        dropped = [n for n, v in (
            ("--mca", opts.mca), ("--ckpt-dir", opts.ckpt_dir),
            ("--restart", opts.restart), ("--hosts", opts.hosts),
            ("--hostfile", opts.hostfile),
            ("--simulate-nodes", opts.simulate),
            ("--preload", opts.preload)) if v]
        if opts.rpp not in (1, "all"):
            # the pool always runs every rank as a thread (hostrun
            # model); any other explicit split cannot be honored
            dropped.append("--ranks-per-proc")
        if dropped:
            sys.stderr.write(
                f"mpirun: --dvm submits to a warm pool and cannot "
                f"honor {', '.join(dropped)} (the pool's launch "
                f"configuration is fixed at dvm start)\n")
            return 2
        from ompi_tpu_torch.tools.dvm import submit
        return submit(opts.dvm, opts.np, opts.prog, opts.args,
                      timeout=opts.timeout or None)
    if opts.ckpt_dir or opts.restart:
        raise NotImplementedError(
            "mpirun --ckpt-dir / --restart need the checkpoint store "
            "(cr/ckpt.py), which is not ported yet (ROADMAP.md A9)")
    # per-job control-plane secret (sec/basic analog): the KV server
    # refuses connections without it.  setdefault so a relaunch under
    # an outer job reuses the outer credential.
    import secrets as _secrets
    os.environ.setdefault("TPUMPI_JOB_SECRET", _secrets.token_hex(16))
    ckpt_env = {}
    if opts.ckpt_keep is not None:
        # job-wide cr_keep default (the MCA env of every rank)
        ckpt_env["TPUMPI_MCA_cr_keep"] = str(opts.ckpt_keep)
    # --mca pairs apply to the LAUNCHER's own registry too (the
    # reference's orterun reads MCA params itself — e.g. the notifier
    # sinks used by the errmgr handlers), not only to rank env
    from ompi_tpu_torch.mca.params import registry as _registry
    for _k, _v in opts.mca:
        try:
            _registry.set(_k, _v)
        except KeyError:
            pass  # rank-side-only param unknown to the launcher
    rpp = opts.np if opts.rpp == "all" else opts.rpp
    # 'all' always means hybrid (even -np 1: device assignment and the
    # app shell still apply); an explicit integer 1 means one process
    # per rank, the classic model
    hybrid = opts.rpp == "all" or rpp > 1
    if hybrid and not opts.prog.endswith(".py"):
        sys.stderr.write(
            "mpirun: --ranks-per-proc > 1 requires a Python "
            "program (ranks run as threads of the app shell)\n")
        return 2

    from ompi_tpu_torch.runtime import ras
    try:
        nodes = ras.allocate(opts.hosts, opts.hostfile, opts.simulate,
                             opts.np)
    except (ValueError, OSError) as e:
        sys.stderr.write(f"mpirun: {e}\n")
        return 2
    # any EXPLICIT allocation goes through the PLM (slot counts and
    # mapping policy enforced uniformly, even for one local node);
    # only the implicit local default uses the direct fork/exec path
    if any(x is not None for x in (opts.hosts, opts.hostfile,
                                   opts.simulate)):
        return run_multinode(opts, nodes, rpp, hybrid, ckpt_env)
    return run_local(opts, rpp, hybrid, ckpt_env)


if __name__ == "__main__":
    sys.exit(main())
