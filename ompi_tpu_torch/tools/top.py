"""ompi_tpu_torch-top: the operator's live view of a DVM pool.

A curses-free terminal tool polling the ``metrics`` RPC
per-session throughput and attribution, queue
depth, latency percentiles derived from the log2 histograms, and the
last-N flight-recorder events.  Plain ANSI home+clear between frames
(pipes and CI logs stay readable — each frame is just text), ``--once``
prints a single frame and exits (scriptable, and what the tests
drive).

Usage:
    python -m ompi_tpu_torch.tools.top <uri_file> [--interval S] [--once]
        [--events N] [--prometheus]
"""

from __future__ import annotations

import argparse
import sys
import time

# scoped counters shown per session, in column order: (pvar, header)
_SESSION_COLS = (
    ("dvm_jobs", "jobs"),
    ("dvm_job_wall_us", "wall_us"),
    ("dvm_queue_wait_us", "qwait_us"),
    # per-session SLI gauges: queue-wait p99 from the
    # banded histogram, preemptions suffered, goodput (successful-run
    # wall time only)
    ("queue_wait_p99_us", "qw_p99_us"),
    ("dvm_sli_preempts", "preempts"),
    ("dvm_sli_goodput_us", "goodput_us"),
    ("coll_device_fused_batches", "batches"),
    ("coll_device_fused_bytes", "bytes"),
    ("coll_device_cache_hits", "hits"),
)


def render(m: dict, events: int = 8) -> str:
    """One frame from one metrics document (pure: testable without a
    socket)."""
    lines = []
    lines.append(
        f"tpu-dvm pid {m.get('pid', '?')}  "
        f"ranks {m.get('active_ranks', 0)}/{m.get('capacity', 0)}  "
        f"sessions {len(m.get('sessions', {}))}  "
        f"queue {m.get('queue_depth', 0)}  "
        f"jobs {m.get('jobs', 0)}  "
        f"scraped {m.get('scraped_ranks', 0)} rank(s)")
    sessions = m.get("sessions", {})
    if sessions:
        hdr = "  sid   np " + " ".join(f"{h:>10}"
                                       for _, h in _SESSION_COLS)
        lines.append(hdr)
        for sid in sorted(sessions, key=int):
            row = sessions[sid]
            cols = " ".join(f"{row.get(p, 0):>10}"
                            for p, _ in _SESSION_COLS)
            dead = " DEAD" if row.get("dead") else ""
            lines.append(f"  s{sid:>3} {row.get('np', 0):>3} "
                         f"{cols}{dead}")
    else:
        lines.append("  (no resident sessions)")
    pcts = m.get("percentiles", {})
    if pcts:
        lines.append("  latency (us, log2-bucket upper bounds):")
        for hname in sorted(pcts):
            p = pcts[hname]
            total = sum(m.get("hists", {}).get(hname, []))
            if not total:
                continue
            lines.append(f"    {hname:<16} p50 {p.get('p50', 0):>9.0f}"
                         f"  p90 {p.get('p90', 0):>9.0f}"
                         f"  p99 {p.get('p99', 0):>9.0f}"
                         f"  (n={total})")
    # control-plane resilience: shown only once the
    # KV client has actually retried/failed-over — a quiet pool keeps
    # a quiet frame
    pv = m.get("pvars", {})
    kv_r = pv.get("kv_retries", 0)
    kv_f = pv.get("kv_failovers", 0)
    kv_c = pv.get("kv_reconnects", 0)
    if kv_r or kv_f or kv_c:
        lines.append(f"  ctrl-plane: kv_retries {kv_r}  "
                     f"kv_reconnects {kv_c}  kv_failovers {kv_f}")
    # host failure domains: shown for multi-host
    # fleets, or after any domain has ever been lost
    h_act = pv.get("fleet_hosts_active", 0)
    h_lost = pv.get("fleet_hosts_lost", 0)
    if m.get("hosts", 1) > 1 or h_lost:
        lines.append(f"  fleet: hosts {h_act} active  "
                     f"{h_lost} lost (lifetime)  "
                     f"{m.get('hosts_rehydrating', 0)} rehydrating")
    # gray-failure health plane: per-host state,
    # score, and the signals that tripped it — plus the lifetime
    # quarantine/migration counters from the fleet_* pvars
    hh = m.get("host_health")
    if hh:
        sick = pv.get("fleet_host_health", 0)
        lines.append(
            f"  health: {sick} host(s) not healthy  "
            f"quarantines {pv.get('fleet_quarantines', 0)}  "
            f"migrations {pv.get('fleet_migrations', 0)} (lifetime)")
        for row in hh:
            state = row.get("state", "healthy")
            if state == "healthy" and not row.get("signals"):
                continue  # a quiet fleet keeps a quiet frame
            sig = ",".join(row.get("signals") or []) or "-"
            lines.append(
                f"    host {row.get('host')}: {state:<11} "
                f"score {row.get('score', 0):>3}  "
                f"beat_ewma {row.get('beat_ewma_ms', 0)}ms  "
                f"grace {row.get('grace_ms', 0)}ms  "
                f"signals [{sig}]")
    # critical-path profiler gauges: what phase is
    # eating the dispatch budget right now, and how skewed arrivals are
    gating = pv.get("obs_critpath_gating_phase")
    phase_us = pv.get("obs_critpath_phase_us")
    if gating or phase_us:
        skew = pv.get("obs_straggler_skew_us", 0)
        parts = ""
        if isinstance(phase_us, dict) and phase_us:
            parts = "  " + " ".join(
                f"{k}={v}us" for k, v in sorted(
                    phase_us.items(), key=lambda kv: -kv[1]))
        lines.append(f"  critpath: gating={gating or '-'}  "
                     f"straggler p90 skew {skew} us{parts}")
    evs = m.get("events", [])
    if events > 0:
        lines.append(f"  flight recorder (last {min(events, len(evs))} "
                     f"of {m.get('events_recorded', len(evs))}):")
        for ev in evs[-events:]:
            args = " ".join(f"{k}={v}"
                            for k, v in ev.get("args", {}).items())
            rank = ev.get("rank", -1)
            who = f"r{rank}" if rank >= 0 else "pool"
            lines.append(f"    {ev.get('ts', 0.0):.3f} {who:>5} "
                         f"{ev.get('name', '?'):<18} {args}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ompi_tpu_torch-top",
        description="Live per-session view of a DVM pool over the "
                    "metrics RPC")
    ap.add_argument("uri_file", help="the pool's --uri-file")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="seconds between polls (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print one frame and exit")
    ap.add_argument("--events", type=int, default=8,
                    help="flight-recorder events per frame")
    ap.add_argument("--prometheus", action="store_true",
                    help="print the Prometheus text exposition "
                         "instead of the table (implies --once)")
    opts = ap.parse_args(argv)

    from ompi_tpu_torch.tools.dvm import DvmClient, DvmError
    try:
        while True:
            with DvmClient(opts.uri_file, connect_timeout=5.0) as cli:
                m = cli.metrics(events=max(opts.events, 1),
                                prometheus=opts.prometheus or None)
            if opts.prometheus:
                sys.stdout.write(m.get("prometheus", ""))
                return 0
            if not opts.once:
                sys.stdout.write("\x1b[H\x1b[2J")
            sys.stdout.write(render(m, opts.events) + "\n")
            sys.stdout.flush()
            if opts.once:
                return 0
            time.sleep(max(0.1, opts.interval))
    except KeyboardInterrupt:
        return 0
    except (DvmError, OSError) as e:
        sys.stderr.write(f"ompi_tpu_torch-top: {e}\n")
        return 1


if __name__ == "__main__":
    sys.exit(main())
