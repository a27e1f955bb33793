"""PLM/HNP: multi-node job orchestration inside mpirun.

Port of the reference's tools/plm.py, a re-design of orte/mca/plm + the HNP role of orterun (launch
sequencing ref: plm_base_launch_support.c:270 setup_job, :550
launch_apps, :855-1176 daemon report-in).  The HNP:

  1. builds a radix **launch tree** over the allocated nodes and
     spawns the root daemons (ssh agent for real hosts, local
     subprocesses for simulated nodes); each daemon tree-spawns its
     subtree (ref: plm_rsh_module.c tree launch) and every daemon
     connects *directly* back here (routed/direct model);
  2. posts daemon report-ins, proc exits, node completions and
     connection losses as EVENTS into the job state machine
     (runtime/statemachine.py — the orte/mca/state analog); the
     errmgr policy lives in the machine's state handlers
     (tools/mpirun.py), not here;
  3. ships each daemon its slice of the job map (launch message);
  4. relays IOF lines directly (data plane, no state involvement).

Like the daemons it spawns, the HNP imports no ``torch``.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

from ompi_tpu_torch.runtime import oob
from ompi_tpu_torch.runtime.ras import Node
from ompi_tpu_torch.runtime.rmaps import NodeMap
from ompi_tpu_torch.tools.tpud import spawn_node_daemon


def build_tree(nodes: List[Node], radix: int) -> List[dict]:
    """Radix tree over the node list (ref: routed/radix layout used
    for the launch fan-out): the HNP spawns nodes 0 … radix-1
    directly; node i tree-spawns nodes [(i+1)*radix, (i+2)*radix).
    Every node appears exactly once and depth is log_radix(N)."""
    entries = [{"name": n.name, "node": n.node_id,
                "simulated": n.simulated, "local": n.local,
                "env": {}, "subtree": []} for n in nodes]

    def attach(i: int) -> dict:
        e = entries[i]
        for c in range((i + 1) * radix,
                       min((i + 2) * radix, len(entries))):
            e["subtree"].append(attach(c))
        return e

    return [attach(i) for i in range(min(radix, len(entries)))]


class HNP:
    def __init__(self, maps: List[NodeMap], agent: str, python: str,
                 pythonpath: str, tree_radix: int = 32,
                 bind_all: bool = False, events=None) -> None:
        """``events``: the job StateMachine — every daemon-side
        happening is posted there (EV_DAEMON_UP / EV_PROC_EXIT /
        EV_NODE_DONE / EV_DAEMON_LOST / EV_CONN_LOST) and the
        machine's handlers decide policy."""
        self.maps = maps
        self.agent = agent
        self.python = python
        self.pythonpath = pythonpath
        self.tree_radix = max(1, tree_radix)
        self.events = events
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("0.0.0.0" if bind_all else "127.0.0.1", 0))
        self.listener.listen(len(maps) * 2 + 8)
        self.port = self.listener.getsockname()[1]
        self.channels: Dict[int, oob.Channel] = {}
        self.lock = threading.Lock()
        self.daemon_procs: List[subprocess.Popen] = []
        self.tag_output = False
        self._stop = False
        # liveness-by-silence state: any traffic from a registered
        # daemon refreshes its stamp; the monitor (heartbeat_budget>0)
        # declares a daemon lost after budget*interval of silence
        self._last_beat: Dict[int, float] = {}
        self._beat_dead: set = set()
        self._grace_timers: Dict[int, threading.Timer] = {}
        # adaptive liveness grace: the SAME per-host beat estimator
        # the resident pool's sweep uses — inter-arrival EWMA
        # + jitter widen a jittery-but-alive daemon's silence horizon
        # above the static budget*interval floor, so it is not
        # declared lost while a crisp daemon keeps the tight floor
        from ompi_tpu_torch.obs.health import HostBeatEstimator
        iv0 = max(0.001, oob.heartbeat_interval_var.value or 0.0)
        floor_s = (max(0, oob.heartbeat_budget_var.value) * iv0
                   + max(0.0, oob.host_grace_var.value))
        self._beat_est = HostBeatEstimator(
            len(maps), floor_ns=max(1, int(floor_s * 1e9)),
            mult=max(1, oob.heartbeat_budget_var.value))
        # every launch sent per node, for idempotent replay after a
        # daemon reconnect (the daemon dedups by lid): a launch lost
        # in a sever window must not strand the node rankless
        self._sent_launches: Dict[int, List[dict]] = {}
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()
        if oob.heartbeat_budget_var.value > 0 \
                and oob.heartbeat_interval_var.value > 0:
            threading.Thread(target=self._beat_monitor,
                             daemon=True).start()

    # ---- daemon spawn + registration -------------------------------
    def addr_for(self, hnp_ip: str) -> str:
        return f"{hnp_ip}:{self.port}"

    def spawn_daemons(self, hnp_ip: str,
                      node_env: Dict[int, Dict[str, str]]) -> None:
        roots = build_tree([m.node for m in self.maps], self.tree_radix)

        def set_env(entry: dict) -> None:
            entry["env"] = node_env.get(entry["node"], {})
            for c in entry["subtree"]:
                set_env(c)

        for r in roots:
            set_env(r)
            self.daemon_procs.append(spawn_node_daemon(
                r, self.addr_for(hnp_ip), self.agent, self.python,
                self.pythonpath))

    def _accept_loop(self) -> None:
        while not self._stop:
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            holder: List = [None]
            ready = threading.Event()

            def handle(msg: dict, _holder=holder, _ready=ready) -> None:
                _ready.wait()  # until holder carries the Channel
                self._dispatch(msg, _holder)

            def on_close(_exc, _holder=holder) -> None:
                node = _holder[0]
                if node is None:
                    # a connection died before registering — fail
                    # registration fast, but never abort a running
                    # job over it (could be a stray probe)
                    self.events.activate("EV_CONN_LOST")
                    return
                with self.lock:
                    # a reconnected channel may already have replaced
                    # this one: only the CURRENT channel's death means
                    # anything
                    if len(_holder) > 1 \
                            and self.channels.get(node) is _holder[1]:
                        self.channels.pop(node, None)
                        self._last_beat.pop(node, None)
                    elif len(_holder) > 1:
                        return
                    if node in self._beat_dead:
                        return  # beat monitor already declared it
                grace = oob.reconnect_grace_var.value
                if grace > 0:
                    # hold the verdict: a daemon surviving a transient
                    # channel drop re-registers within the grace and
                    # the job never notices
                    t = threading.Timer(grace, self._grace_expire,
                                        args=(node,))
                    t.daemon = True
                    with self.lock:
                        old = self._grace_timers.pop(node, None)
                        self._grace_timers[node] = t
                    if old is not None:
                        old.cancel()
                    t.start()
                else:
                    self.events.activate("EV_DAEMON_LOST", node=node)

            ch = oob.Channel(conn, handle, on_close)
            holder.append(ch)
            ready.set()

    def _dispatch(self, msg: dict, holder: List) -> None:
        op = msg.get("op")
        if holder[0] is None and op != "register" \
                and os.environ.get("TPUMPI_JOB_SECRET"):
            # nothing but an authenticating register may ride an
            # unregistered channel: an injected proc_exit/iof from a
            # stray local process must never reach the state machine
            # (sec/basic: the whole connection is gated)
            if len(holder) > 1:
                holder[1].close()
            return
        if op == "register":
            import hmac
            want = os.environ.get("TPUMPI_JOB_SECRET")
            if want and not (isinstance(msg.get("secret"), str)
                             and hmac.compare_digest(msg["secret"],
                                                     want)):
                # unauthenticated daemon registration: drop the
                # channel (sec/basic: credential checked at accept)
                if len(holder) > 1:
                    holder[1].close()
                return
            node = msg["node"]
            with self.lock:
                holder[0] = node
                # holder[1] is the Channel (appended in _accept_loop)
                if len(holder) > 1:
                    self.channels[node] = holder[1]
                self._last_beat[node] = time.monotonic()
                self._beat_dead.discard(node)
                timer = self._grace_timers.pop(node, None)
            if timer is not None:
                timer.cancel()  # reconnected within the grace window
            if msg.get("reconnect"):
                # replay every launch this node was ever sent; any it
                # already acted on is deduplicated daemon-side by lid
                with self.lock:
                    replay = list(self._sent_launches.get(node, ()))
                for m in replay:
                    try:
                        holder[1].send(m)
                    except (IndexError, ConnectionError, OSError):
                        break
            else:
                self.events.activate("EV_DAEMON_UP", node=node)
        elif op == "beat":
            pass  # liveness stamped below for every registered op
        elif op == "iof":
            out = sys.stdout.buffer if msg["stream"] == "out" \
                else sys.stderr.buffer
            data = msg["data"].encode("latin-1")
            if self.tag_output:
                out.write(b"[" + msg["tag"].encode() + b"]" + data)
            else:
                out.write(data)
            out.flush()
        elif op == "proc_exit":
            if msg["code"] != 0:
                self.events.activate(
                    "EV_PROC_EXIT", tag=msg["tag"], code=msg["code"],
                    error=msg.get("error", ""))
        elif op == "node_done":
            self.events.activate("EV_NODE_DONE", node=msg["node"])
        node = holder[0]
        if node is not None:
            # ANY traffic from a registered daemon proves liveness —
            # beats just guarantee a minimum rate during quiet phases
            with self.lock:
                if node in self._last_beat:
                    self._last_beat[node] = time.monotonic()
                    self._beat_est.note(node, time.monotonic_ns())

    def _grace_expire(self, node: int) -> None:
        with self.lock:
            self._grace_timers.pop(node, None)
            back = node in self.channels
        if not back and not self._stop:
            self.events.activate("EV_DAEMON_LOST", node=node)

    def _beat_monitor(self) -> None:
        iv = oob.heartbeat_interval_var.value
        budget = oob.heartbeat_budget_var.value
        # a daemon's death takes every resident rank of its HOST with
        # it — oob_host_grace_s buys extra silence before that whole
        # failure domain is declared lost (one knob paces this monitor
        # and the DVM host-liveness plane alike)
        horizon = budget * iv + max(0.0, oob.host_grace_var.value)
        est = self._beat_est
        while not self._stop:
            time.sleep(iv / 2)
            now = time.monotonic()
            with self.lock:
                # per-node adaptive horizon, floored at the static
                # one: a node whose own beat EWMA/jitter says "slow
                # but alive" earns extra silence before the verdict
                stale = [n for n, t in self._last_beat.items()
                         if now - t > max(horizon,
                                          est.grace_ns(n) / 1e9)
                         and n not in self._beat_dead]
            for node in stale:
                with self.lock:
                    if node in self._beat_dead \
                            or node not in self._last_beat:
                        continue
                    self._beat_dead.add(node)
                    self._last_beat.pop(node, None)
                    ch = self.channels.pop(node, None)
                if self._stop:
                    return
                sys.stderr.write(
                    f"mpirun: daemon on node {node} missed {budget} "
                    f"heartbeats ({horizon:.1f}s silent); "
                    f"declaring it lost\n")
                if ch is not None:
                    ch.close()  # marks _closed: on_close won't double-fire
                self.events.activate("EV_DAEMON_LOST", node=node)

    # ---- job launch + supervision ----------------------------------
    def send_launch(self, node: int, msg: dict) -> None:
        """Send one launch message to ``node``, recording it for
        replay should the daemon's channel drop and reconnect.  The
        lid makes the replay idempotent daemon-side."""
        with self.lock:
            sent = self._sent_launches.setdefault(node, [])
            msg.setdefault("lid", f"launch:{node}:{len(sent)}")
            sent.append(msg)
            ch = self.channels[node]  # KeyError if the daemon is gone
        ch.send(msg)

    def launch(self, prog: str, args: List[str],
               env: Dict[str, str], wdir: Optional[str],
               preload: bool = False) -> None:
        """``preload``: ship the program's bytes in the launch message
        (filem/raw analog, ref: orte/mca/filem/raw — pre-stage files
        to nodes without a shared filesystem); each daemon writes it
        into its session dir and runs that copy."""
        prog_data = None
        if preload:
            import base64
            with open(prog, "rb") as fh:
                prog_data = base64.b64encode(fh.read()).decode("ascii")
        for m in self.maps:
            if not m.procs:
                self.events.activate("EV_NODE_DONE",
                                     node=m.node.node_id)
                continue
            nid = m.node.node_id
            try:
                self.send_launch(nid, {
                    "op": "launch", "prog": prog, "args": args,
                    "prog_data": prog_data,
                    "wdir": wdir, "env": env,
                    "procs": [{"rank_base": p.rank_base,
                               "nlocal": p.nlocal} for p in m.procs],
                })
            except (KeyError, ConnectionError, OSError):
                # daemon died between report-in and launch: the
                # machine's DAEMON_FAILED handler applies the policy
                self.events.activate("EV_DAEMON_LOST", node=nid)

    def shutdown(self, failed: bool) -> None:
        op = "kill" if failed else "exit"
        with self.lock:
            chans = list(self.channels.values())
        for ch in chans:
            try:
                ch.send({"op": op})
            except (ConnectionError, OSError):
                pass
        t_end = time.monotonic() + 5.0
        for p in self.daemon_procs:
            while p.poll() is None and time.monotonic() < t_end:
                time.sleep(0.02)
            if p.poll() is None:
                p.terminate()
        for p in self.daemon_procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=1.0)
                except subprocess.TimeoutExpired:
                    p.kill()
        self._stop = True
        try:
            self.listener.close()
        except OSError:
            pass
