"""tpud: the per-node daemon of the multi-host launch model.

Port of the reference's tools/tpud.py, a re-design of the orted (ref: orte/orted/orted_main.c): started on each
allocated node by the PLM (ssh agent, or a plain local subprocess for
simulated nodes), it connects back to the HNP's control port (OOB),
registers, optionally **tree-spawns** a subtree of further daemons
(the plm_rsh tree-launch, ref: plm_rsh_module.c:169,328-387), then
waits for a launch message, fork/execs its local launch units (odls
analog, ref: odls_default_module.c:338-437), relays their stdio to
the HNP (IOF analog), reports exits, and kills everything on command
(errmgr kill path).

Launch units are either classic single-rank processes or hybrid app
shells (ompi_tpu_torch.tools.hostrun) owning a contiguous block of
rank-threads — the daemon does not care, it just execs what the map
says and injects the right TPUMPI_* identity env.  The daemon imports
no ``torch``: it starts fast, and no child inherits a CUDA context
from it (nothing it imports touches a card).

argv: --hnp HOST:PORT --node ID --name NAME [--subtree B64JSON]
      [--agent CMD] [--python EXE]

Fleet host-agent mode: ``--fleet URI_FILE --host K`` instead of
``--hnp`` turns the daemon into the liveness agent of one host failure
domain of a resident pool's fleet (tools/dvm.py ``--hosts N``): it
dials the pool's port, registers its domain, and beats until killed.
Silence past the pool's grace horizon (or a SIGKILL from
``tpu-dvm --kill-host`` / ft_inject ``host_kill``) is what the pool's
host-liveness plane turns into ONE failure record covering every
resident rank of the host.
"""

from __future__ import annotations

import argparse
import base64
import json
import os
import queue
import shlex
import subprocess
import sys
import tempfile
import threading
import time
from typing import List, Optional

from ompi_tpu_torch import trace
from ompi_tpu_torch.runtime import oob


def daemon_cmd(python: str, hnp: str, name: str, node_id: int,
               subtree: Optional[list], agent: str,
               pythonpath: str) -> List[str]:
    """The tpud argv for one node (used by both the HNP's plm and a
    tree-spawning parent daemon)."""
    cmd = [python, "-m", "ompi_tpu_torch.tools.tpud",
           "--hnp", hnp, "--node", str(node_id), "--name", name,
           "--agent", agent, "--python", python]
    if subtree:
        blob = base64.b64encode(json.dumps(subtree).encode()).decode()
        cmd += ["--subtree", blob]
    if pythonpath:
        cmd += ["--pythonpath", pythonpath]
    return cmd


def spawn_node_daemon(entry: dict, hnp: str, agent: str, python: str,
                      pythonpath: str) -> subprocess.Popen:
    """Start one daemon described by a tree entry
    {name, node, simulated, env, subtree} — locally for simulated
    nodes, through the launch agent (ssh ...) otherwise."""
    cmd = daemon_cmd(python, hnp, entry["name"], entry["node"],
                     entry.get("subtree"), agent, pythonpath)
    env = dict(os.environ)
    env.update(entry.get("env") or {})
    if pythonpath:
        env["PYTHONPATH"] = pythonpath + (
            os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if entry.get("simulated") or entry.get("local"):
        return subprocess.Popen(cmd, env=env,
                                stdout=subprocess.DEVNULL,
                                stderr=None)
    # remote: agent + host + a single shell command string that
    # re-exports the env the daemon needs (homogeneous install paths
    # assumed, like the reference's default --prefix behavior)
    exports = " ".join(
        f"{k}={shlex.quote(v)}"
        for k, v in (entry.get("env") or {}).items())
    if pythonpath:
        exports += f" PYTHONPATH={shlex.quote(pythonpath)}"
    remote = f"env {exports} " + " ".join(shlex.quote(c) for c in cmd)
    return subprocess.Popen(shlex.split(agent) + [entry["name"], remote],
                            stdout=subprocess.DEVNULL, stderr=None)


def _die_with_parent() -> None:
    """prctl(PR_SET_PDEATHSIG, SIGKILL) in the child: a rank must not
    outlive its daemon (the reference's orted session bookkeeping kills
    local procs on daemon death; a SIGKILL'd daemon here would
    otherwise leave orphan ranks running, making daemon-loss recovery
    ambiguous — the ranks being remapped must actually be dead)."""
    try:
        import ctypes
        libc = ctypes.CDLL(None, use_errno=True)
        libc.prctl(1, 9, 0, 0, 0)  # PR_SET_PDEATHSIG = 1, SIGKILL = 9
    except Exception:  # noqa: BLE001
        pass


class _Unit:
    """One launched local unit (process) and its IOF plumbing."""

    def __init__(self, proc: subprocess.Popen, tag: str,
                 rank_base: int, nlocal: int) -> None:
        self.proc = proc
        self.tag = tag
        self.rank_base = rank_base
        self.nlocal = nlocal
        self.reported = False


def host_agent(opts) -> int:
    """One tpud per host failure domain of a resident pool's fleet:
    register on the pool's control port, then beat.  The agent carries no state —
    its PROCESS is the liveness signal, so ft_inject host_kill
    SIGKILLs it (a real dead daemon, not a simulated one) and the
    pool's detector runs the production silence path."""
    from ompi_tpu_torch.tools.dvm import DvmClient, DvmError
    tag = f"tpud[host{opts.host}]"
    try:
        client = DvmClient(opts.fleet)
        resp = client._rpc({"op": "host_register", "host": opts.host,
                            "pid": os.getpid()})
    except DvmError as e:
        sys.stderr.write(f"{tag}: {e}\n")
        return 1
    if "error" in resp:
        sys.stderr.write(f"{tag}: {resp['error']}\n")
        client.close()
        return 1
    grace = float(resp.get("grace_s", 1.0))
    iv = max(0.05, grace / 6.0)
    from ompi_tpu_torch import ft_inject
    slow = ft_inject.host_slow_injector(opts.host)
    if slow is not None:
        # gray failure (ft_inject host_slow): beat SLOWER — but keep
        # beating.  The liveness grace must never fire; only the
        # health plane's beat-EWMA scoring can see this host is sick
        iv = slow.beat_interval_s(iv, grace=grace)
        sys.stderr.write(f"{tag}: host_slow armed — beating "
                         f"{slow.factor}x slow ({iv:.2f}s)\n")
    sys.stderr.write(f"{tag}: registered with fleet incarnation "
                     f"{resp.get('incarnation')} (beat every "
                     f"{iv:.2f}s)\n")
    while True:
        time.sleep(iv)
        try:
            r = client._rpc({"op": "host_beat", "host": opts.host})
        except (DvmError, OSError):
            break  # pool gone; an agent has nothing to clean up
        if "error" in r or not r.get("ok"):
            break
    client.close()
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="tpud")
    ap.add_argument("--hnp", default=None)
    ap.add_argument("--node", type=int, default=0)
    ap.add_argument("--name", default=None)
    ap.add_argument("--subtree", default=None)
    ap.add_argument("--agent", default="ssh")
    ap.add_argument("--python", default=sys.executable)
    ap.add_argument("--pythonpath", default="")
    ap.add_argument("--fleet", default=None, metavar="URI_FILE",
                    help="host-agent mode: the resident pool's uri file")
    ap.add_argument("--host", type=int, default=0,
                    help="host failure-domain id this agent covers "
                         "(with --fleet)")
    opts = ap.parse_args(argv)
    if opts.fleet is not None:
        return host_agent(opts)
    if not opts.hnp or opts.name is None:
        ap.error("--hnp and --name are required (or use --fleet for "
                 "host-agent mode)")

    units: List[_Unit] = []
    units_lock = threading.Lock()
    expected_units = [0]  # set from the launch message BEFORE spawning
    children: List[subprocess.Popen] = []  # tree-spawned daemons
    done = threading.Event()
    killed = threading.Event()
    session = tempfile.mkdtemp(prefix=f"tpumpi-node{opts.node}-")
    # the address this node uses to reach the HNP == the address peers
    # can reach *us* at (if/reachable analog)
    if_ip = oob.local_ip_toward(opts.hnp)

    chan_box: List[Optional[oob.Channel]] = [None]

    proxies: list = []

    seen_lids: set = set()

    def report(msg: dict) -> bool:
        """Best-effort send; returns False when the channel is down
        so state-bearing messages (proc_exit, node_done) can be
        re-offered after the reconnect instead of silently lost."""
        ch = chan_box[0]
        if ch is None:
            return False
        try:
            ch.send(msg)
            return True
        except (ConnectionError, OSError):
            return False

    def forward_iof(stream, tag: str, which: str) -> None:
        try:
            for line in iter(stream.readline, b""):
                msg = {"op": "iof", "tag": tag, "stream": which,
                       "data": line.decode("latin-1")}
                # a line is user output, not telemetry: hold it across
                # a channel drop and re-offer after the reconnect
                while not report(msg):
                    if done.is_set() or killed.is_set():
                        return
                    time.sleep(0.05)
        except (OSError, ValueError):
            pass

    def launch(msg: dict) -> None:
        with units_lock:
            expected_units[0] += len(msg["procs"])
        env_base = dict(os.environ)
        env_base.update(msg.get("env") or {})
        env_base["TPUMPI_SESSION_DIR"] = session
        env_base["TPUMPI_NODE"] = str(opts.node)
        # node NAME identity: dfs uri host matching (ranks and the
        # proxy both resolve file://<this-name>/... locally)
        env_base["TPUMPI_NODE_NAME"] = opts.name
        os.environ["TPUMPI_NODE_NAME"] = opts.name
        env_base.setdefault("TPUMPI_MCA_btl_tcp_if_ip", if_ip)
        # KV aggregation proxy (grpcomm analog): local ranks talk to
        # this daemon, the central server sees ONE connection per node
        node_ranks = sum(max(1, p["nlocal"]) for p in msg["procs"])
        if env_base.get("TPUMPI_KV_ADDR") and node_ranks:
            from ompi_tpu_torch.runtime.kvstore import KVProxy
            try:
                proxy = KVProxy(env_base["TPUMPI_KV_ADDR"],
                                local_expected=node_ranks)
                proxies.append(proxy)
                env_base["TPUMPI_KV_ADDR"] = proxy.addr
            except OSError:
                pass  # fall back to direct connections
        prog = msg["prog"]
        # filem/raw analog: a preloaded program arrives as bytes in
        # the launch message; write it into the session dir and run
        # the staged copy (no shared filesystem required)
        if msg.get("prog_data"):
            staged = os.path.join(
                session, "staged_" + os.path.basename(prog))
            with open(staged, "wb") as fh:
                fh.write(base64.b64decode(msg["prog_data"]))
            os.chmod(staged, 0o755)  # binaries exec directly
            prog = staged
        args = msg.get("args") or []
        node_base = min(p["rank_base"] for p in msg["procs"])
        env_base["TPUMPI_NODE_RANK_BASE"] = str(node_base)
        local_idx = 0  # rank index WITHIN this node (binding input)
        for spec in msg["procs"]:
            env = dict(env_base)
            base, nlocal = spec["rank_base"], spec["nlocal"]
            if nlocal:  # hybrid app shell
                env["TPUMPI_RANK_BASE"] = str(base)
                env["TPUMPI_LOCAL_RANKS"] = str(nlocal)
                env["TPUMPI_LOCAL_SIZE"] = str(nlocal)
                cmd = [opts.python, "-m", "ompi_tpu_torch.tools.hostrun",
                       prog] + args
                tag = f"{opts.name}:{base}-{base + nlocal - 1}" \
                    if nlocal > 1 else f"{opts.name}:{base}"
            else:
                env["TPUMPI_RANK"] = str(base)
                env["TPUMPI_LOCAL_RANK"] = str(local_idx)
                env["TPUMPI_LOCAL_SIZE"] = str(node_ranks)
                cmd = ([opts.python, prog] + args
                       if prog.endswith(".py") else [prog] + args)
                tag = f"{opts.name}:{base}"
            local_idx += max(1, nlocal)
            try:
                p = subprocess.Popen(cmd, env=env, cwd=msg.get("wdir"),
                                     stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE,
                                     preexec_fn=_die_with_parent)
            except OSError as e:
                with units_lock:
                    expected_units[0] -= 1
                report({"op": "proc_exit", "tag": tag, "code": 127,
                        "error": f"exec failed: {e}"})
                continue
            u = _Unit(p, tag, base, nlocal)
            with units_lock:
                units.append(u)
            for stream, which in ((p.stdout, "out"), (p.stderr, "err")):
                threading.Thread(target=forward_iof,
                                 args=(stream, tag, which),
                                 daemon=True).start()

    def kill_local(grace: float = 2.0) -> None:
        killed.set()
        with units_lock:
            procs = [u.proc for u in units]
        for p in procs + children:
            if p.poll() is None:
                p.terminate()
        t_end = time.monotonic() + grace
        for p in procs + children:
            while p.poll() is None and time.monotonic() < t_end:
                time.sleep(0.02)
            if p.poll() is None:
                p.kill()

    launch_q: "queue.Queue[dict]" = queue.Queue()

    def handle(msg: dict) -> None:
        op = msg.get("op")
        if op == "launch":
            # the HNP replays launches after a reconnect (a launch in
            # flight during a channel drop is otherwise lost): dedup
            # by lid so a replayed launch never double-spawns
            lid = msg.get("lid")
            if lid is not None:
                if lid in seen_lids:
                    return
                seen_lids.add(lid)
            # hand off to the MAIN loop: PR_SET_PDEATHSIG fires when
            # the forking THREAD dies, so ranks must never be forked
            # from a channel reader thread (a severed channel would
            # SIGKILL every rank on the node)
            launch_q.put(msg)
        elif op == "kill":
            kill_local()
            done.set()
        elif op == "metrics":
            # process-job equivalent of the DVM metrics RPC: the HNP
            # (or an attach tool routed through it) asks this node for
            # its live pvar/histogram/flight-recorder snapshot; the
            # reply rides the OOB channel like iof/proc_exit
            from ompi_tpu_torch import obs as _obs
            try:
                m = _obs.local_metrics(
                    events=int(msg.get("events", 16)),
                    prefix=msg.get("prefix"))
            except Exception as e:  # noqa: BLE001
                m = {"error": str(e)[:200]}
            report({"op": "metrics", "node": opts.node,
                    "name": opts.name, "metrics": m})
        elif op == "exit":
            done.set()

    def register_msg(reconnect: bool = False) -> dict:
        m = {"op": "register", "node": opts.node, "name": opts.name,
             "if_ip": if_ip, "pid": os.getpid(),
             "secret": os.environ.get("TPUMPI_JOB_SECRET", "")}
        if reconnect:
            m["reconnect"] = True
        return m

    def _reconnect_hnp() -> None:
        """The HNP channel dropped but nobody told us to die: a
        transient network fault (or injected sever) must not take the
        node's ranks with it.  Exponential backoff + jitter within a
        retry budget; only an exhausted budget falls back to the
        orphan-kill behavior."""
        tr = trace.global_tracer()
        t0 = tr.start() if tr is not None else None
        delay = max(0.01, oob.retry_delay_var.value)
        for attempt in range(max(1, oob.retry_max_var.value)):
            if done.is_set() or killed.is_set():
                return
            # shared control-plane pacing: same jittered policy the
            # KV failover sleeps on (oob.backoff_s)
            time.sleep(oob.backoff_s(attempt, delay))
            try:
                ch = oob.connect(opts.hnp, handle, on_close, timeout=10)
                ch.send(register_msg(reconnect=True))
            except (ConnectionError, OSError):
                continue
            chan_box[0] = ch
            if tr is not None:
                tr.end_slow(t0, "oob_reconnect", "oob",
                            node=opts.node, attempts=attempt + 1,
                            ok=1)
            return
        if tr is not None:
            tr.end_slow(t0, "oob_reconnect", "oob", node=opts.node,
                        attempts=oob.retry_max_var.value, ok=0)
        sys.stderr.write(f"tpud[{opts.name}]: HNP unreachable after "
                         f"{oob.retry_max_var.value} reconnect "
                         f"attempts; killing local procs\n")
        kill_local()
        done.set()

    def on_close(_exc) -> None:
        if done.is_set() or killed.is_set():
            done.set()
            return
        # reconnect off the dying reader thread
        threading.Thread(target=_reconnect_hnp, daemon=True).start()

    try:
        chan = oob.connect(opts.hnp, handle, on_close)
    except OSError as e:
        sys.stderr.write(f"tpud[{opts.name}]: cannot reach HNP "
                         f"{opts.hnp}: {e}\n")
        return 1
    chan_box[0] = chan

    # tree spawn before registering: children registrations overlap
    # with ours (the plm_rsh tree fan-out)
    subtree = []
    if opts.subtree:
        subtree = json.loads(base64.b64decode(opts.subtree))
    for entry in subtree:
        children.append(spawn_node_daemon(
            entry, opts.hnp, opts.agent, opts.python, opts.pythonpath))

    chan.send(register_msg())

    # fault injection: node-level chaos scenarios armed by MCA plan
    # (ompi_tpu_torch/ft_inject) — only on the configured victim node
    from ompi_tpu_torch import ft_inject
    for fault in ft_inject.node_faults(opts.node):
        if fault == "daemon_kill":
            # hard exit, no cleanup: PDEATHSIG reaps the ranks, the
            # HNP learns via heartbeat silence / channel death
            t = threading.Timer(ft_inject.after_s(),
                                lambda: os._exit(137))
        else:  # oob_sever: drop the channel WITHOUT marking it
            # closed, so on_close fires and the reconnect path runs
            def _sever() -> None:
                ch = chan_box[0]
                if ch is not None:
                    try:
                        ch.sock.shutdown(2)  # SHUT_RDWR
                    except OSError:
                        pass
            t = threading.Timer(ft_inject.after_s(), _sever)
        t.daemon = True
        t.start()

    # rank_kill: SIGKILL the launch unit hosting the victim GLOBAL
    # rank — a REAL dead child (not a simulated one), so detection
    # runs the production path: proc-exit report → HNP ulfm errmgr
    # policy → job-wide failure record
    if "rank_kill" in ft_inject.plan():
        victim = ft_inject.rank_kill_victim()

        def _rank_kill() -> None:
            with units_lock:
                snapshot = list(units)
            for u in snapshot:
                lo, hi = u.rank_base, u.rank_base + max(1, u.nlocal)
                if lo <= victim < hi and u.proc.poll() is None:
                    try:
                        u.proc.kill()
                    except OSError:
                        pass
                    return

        tk = threading.Timer(ft_inject.after_s(), _rank_kill)
        tk.daemon = True
        tk.start()

    # monitor loop: report unit exits; finish when every unit the
    # launch message promised has been spawned AND exited (guards the
    # race where the first unit dies while later ones are still being
    # spawned on the OOB reader thread)
    hb_iv = oob.heartbeat_interval_var.value
    next_beat = time.monotonic() + hb_iv if hb_iv > 0 else None
    while not done.is_set():
        time.sleep(0.02)
        while True:
            try:
                launch(launch_q.get_nowait())
            except queue.Empty:
                break
        if next_beat is not None and time.monotonic() >= next_beat:
            # liveness beat: lets the HNP detect a wedged/killed
            # daemon by SILENCE (budget * interval) instead of
            # waiting for kernel TCP death, which can take minutes
            report({"op": "beat", "node": opts.node})
            _tr = trace.global_tracer()
            if _tr is not None:
                _tr.instant("oob_beat", "oob", node=opts.node)
            next_beat = time.monotonic() + hb_iv
        with units_lock:
            snapshot = list(units)
            expected = expected_units[0]
        alive = 0
        for u in snapshot:
            code = u.proc.poll()
            if code is None:
                alive += 1
            elif not u.reported:
                # only mark delivered on success: a proc_exit lost in
                # a channel-drop window is re-offered next tick, after
                # the reconnect
                u.reported = report({"op": "proc_exit", "tag": u.tag,
                                     "code": code})
        if expected > 0 and len(snapshot) == expected and alive == 0 \
                and not killed.is_set():
            if report({"op": "node_done", "node": opts.node}):
                break

    # Tree children have their own direct HNP channels: on clean local
    # completion they exit when the HNP tells them (exit/kill), or via
    # our on_close kill if the HNP dies — so wait on them WITHOUT a
    # kill timeout (a timed terminate() here would orphan a subtree
    # whose ranks simply run longer than ours, and the HNP errmgr
    # would then kill the whole job as a lost-daemon failure).
    while (not killed.is_set()
           and any(c.poll() is None for c in children)):
        time.sleep(0.05)
    import shutil
    shutil.rmtree(session, ignore_errors=True)
    done.set()  # a reconnect attempt racing teardown must stand down
    ch = chan_box[0]
    if ch is not None:
        ch.close()
    try:
        trace.dump_global(f"tpud-{opts.name}")
    except Exception:  # noqa: BLE001 — diagnostics never fail exit
        pass
    return 0


if __name__ == "__main__":
    sys.exit(main())
