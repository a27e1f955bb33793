"""Debugger attach tool — the MPIR interface analog.

Re-design of the reference's MPIR debugger rendezvous
(ref: ompi/debuggers/ompi_debuggers.c — mpirun publishes
MPIR_proctable[] = {host, executable, pid} for TotalView-class
debuggers to read).  TPU-native shape: mpirun writes
``proctable.json`` into the job session directory; this tool reads
it, prints the rank->pid map, and with ``--stacks`` makes every
local rank dump ALL its thread stacks to its stderr (ranks install a
SIGUSR1 faulthandler at init) — the "where is my hung 256-rank job
stuck" workflow without a real debugger.

``--events`` extends the workflow to the telemetry plane
given a DVM uri file (or its neighboring
``.proctable.json``), query the pool's flight recorder LIVE over the
metrics RPC; when the pool is gone, fall back to the
``<uri>.events.json`` ring it persisted at halt or on session
failure — the durable record of what happened to a pool that no
longer exists.

Usage:
    python -m ompi_tpu_torch.tools.attach <session_dir|proctable.json|uri>
        [--stacks] [--events [N]]
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys


def load_proctable(path: str) -> list:
    if os.path.isdir(path):
        path = os.path.join(path, "proctable.json")
    with open(path) as fh:
        return json.load(fh)


def _resolve_uri(path: str) -> str:
    """The DVM uri file for whatever the operator pointed at: the uri
    file itself, or the ``<uri>.proctable.json`` the pool writes next
    to it."""
    suffix = ".proctable.json"
    if path.endswith(suffix):
        return path[:-len(suffix)]
    return path


def _format_event(ev: dict) -> str:
    args = " ".join(f"{k}={v}" for k, v in ev.get("args", {}).items())
    rank = ev.get("rank", -1)
    who = f"r{rank}" if rank >= 0 else "pool"
    return (f"{ev.get('ts', 0.0):.6f}  {who:>5}  "
            f"{ev.get('name', '?'):<18} {args}")


def show_events(target: str, last: int) -> int:
    """Print the flight-recorder tail: live over the metrics RPC when
    the pool answers, else from the persisted ring."""
    uri = _resolve_uri(target)
    events = None
    source = None
    recorded = dropped = 0
    if os.path.isfile(uri):
        try:
            from ompi_tpu_torch.tools.dvm import DvmClient, DvmError
            with DvmClient(uri, connect_timeout=3.0) as cli:
                m = cli.metrics(events=last)
            events = m.get("events", [])
            recorded = int(m.get("events_recorded", len(events)))
            dropped = int(m.get("events_dropped", 0))
            source = "live"
        except (DvmError, OSError, ValueError):
            events = None
    if events is None:
        persisted = f"{uri}.events.json"
        try:
            with open(persisted) as fh:
                dump = json.load(fh)
            events = dump.get("events", [])
            recorded = int(dump.get("recorded", len(events)))
            dropped = int(dump.get("dropped", 0))
            source = persisted
        except (OSError, ValueError):
            sys.stderr.write(
                f"attach: no pool answering at {uri} and no "
                f"persisted ring at {persisted}\n")
            return 1
    if last > 0:
        events = events[-last:]
    sys.stdout.write(f"flight recorder ({source}): "
                     f"{len(events)} event(s)\n")
    # never return a short tail silently: when the bounded ring has
    # already rotated events out (or the caller asked for more than
    # survive), say exactly how many are gone and why
    if dropped > 0:
        sys.stdout.write(
            f"attach: note: {dropped} older event(s) of {recorded} "
            "recorded were dropped by the bounded ring "
            "(obs_events_ring) and cannot be shown\n")
    elif last > 0 and recorded > len(events):
        sys.stdout.write(
            f"attach: note: showing the newest {len(events)} of "
            f"{recorded} recorded event(s)\n")
    for ev in events:
        sys.stdout.write(_format_event(ev) + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ompi_tpu_torch-attach")
    ap.add_argument("session", help="job session dir, proctable.json, "
                                    "or DVM uri file")
    ap.add_argument("--stacks", action="store_true",
                    help="SIGUSR1 every local pid: each rank dumps "
                         "all thread stacks to its stderr")
    ap.add_argument("--events", nargs="?", const=32, type=int,
                    default=None, metavar="N",
                    help="show the last N flight-recorder events "
                         "(default 32): live from the pool's metrics "
                         "RPC, or from the persisted <uri>.events.json "
                         "after a halt/failure")
    opts = ap.parse_args(argv)
    if opts.events is not None:
        return show_events(opts.session, opts.events)
    try:
        table = load_proctable(opts.session)
    except (OSError, ValueError) as e:
        sys.stderr.write(f"attach: cannot read proctable: {e}\n")
        return 1
    for ent in table:
        # DVM-resident ranks are threads of the pool process; the
        # proctable names the thread so a --stacks dump is navigable
        thread = f"  thread {ent['thread']}" if "thread" in ent else ""
        # multi-host fleets stamp each rank's failure domain — which
        # host's death takes it down — next to the physical host
        hdom = f"  domain host{ent['hdom']}" if "hdom" in ent else ""
        sys.stdout.write(
            f"rank(s) {ent['tag']:>8}  pid {ent['pid']:>7}  "
            f"host {ent.get('host', 'localhost')}{hdom}{thread}\n")
    if opts.stacks:
        import socket as _socket
        me = _socket.gethostname()
        sent = 0
        signalled = set()
        for ent in table:
            if ent.get("host", me) != me:
                continue  # never signal pids on another host
            pid = int(ent["pid"])
            if pid in signalled:
                continue  # DVM proctables list one pool pid per rank
            signalled.add(pid)
            # pid-recycling guard: only signal a process that still
            # looks like a Python rank (SIGUSR1's default action
            # TERMINATES a process with no faulthandler registered)
            try:
                with open(f"/proc/{pid}/cmdline", "rb") as fh:
                    cmdline = fh.read()
            except OSError:
                continue  # gone
            if b"python" not in cmdline:
                continue
            try:
                os.kill(pid, signal.SIGUSR1)
                sent += 1
            except (OSError, ValueError):
                pass
        sys.stdout.write(f"attach: signalled {sent}/{len(table)} "
                         f"pids (stacks go to job stderr)\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
