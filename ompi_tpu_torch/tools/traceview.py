"""traceview: merge per-rank trace dumps into one corrected timeline.

Consumes the per-rank JSON files written at MPI_Finalize when
``--mca trace_enable 1 --mca trace_dump_path PREFIX`` is set, applies
the clock offsets measured by ``tools/mpisync.py`` (its JSON summary
line: ``{"offsets_us": [...], ...}`` where offset = remote_clock -
rank0_clock at minimum RTT, so rank0_time = t_remote - offset), and
emits:

  * Chrome trace-event JSON (perfetto / chrome://tracing loadable):
    one process per rank, one thread per span category, "X" complete
    events with microsecond ts/dur, "i" instants for annotations
    (fault injections, OOB heartbeats).
  * A text summary on stdout: slowest spans per category and the
    straggler ranks of correlated collectives (who arrives last at
    the rendezvous, by how much).

Usage:

    python -m ompi_tpu_torch.tools.traceview trace-r*.json \
        [--sync mpisync.json] [-o merged.json] [--top 5]

Without --sync the offsets auto-embedded into the dumps at finalize
(``trace.sync_state`` runs mpisync before the fence) are used; when
neither is present the raw clocks pass through — fine for thread-rank
worlds sharing one system clock, wrong across hosts.
"""

from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Dict, List, Optional


def load_dumps(paths: List[str]) -> List[dict]:
    """Load per-rank dump files (globs expanded for callers that
    quote them), sorted by rank."""
    files: List[str] = []
    for p in paths:
        hits = sorted(glob.glob(p))
        files.extend(hits if hits else [p])
    dumps = []
    for f in files:
        with open(f) as fh:
            d = json.load(fh)
        if "events" not in d or "rank" not in d:
            raise ValueError(f"{f}: not a trace dump (missing "
                             f"rank/events)")
        dumps.append(d)
    dumps.sort(key=lambda d: d["rank"])
    return dumps


def load_offsets(path: Optional[str]) -> List[float]:
    """Per-rank offsets (us) from an mpisync JSON summary — either
    the bare JSON object or a captured stdout whose LAST json line is
    the summary (how test_mpisync_reports_offsets consumes it)."""
    if not path:
        return []
    with open(path) as fh:
        text = fh.read()
    try:
        data = json.loads(text)
    except ValueError:
        data = None
        for line in reversed(text.strip().splitlines()):
            line = line.strip()
            if line.startswith("{"):
                data = json.loads(line)
                break
        if data is None:
            raise ValueError(f"{path}: no JSON object found")
    if "offsets_us" not in data:
        raise ValueError(f"{path}: missing offsets_us (not an mpisync "
                         f"summary?)")
    return [float(o) for o in data["offsets_us"]]


def embedded_offsets(dumps: List[dict]) -> List[float]:
    """Per-rank offsets (us) auto-embedded into the dumps at finalize
    (trace.sync_state runs mpisync before the finalize fence).  The
    first dump carrying a table wins — every rank embeds the same
    Bcast-distributed table, so any copy is authoritative.  Empty when
    the run predates embedding or synced fewer than 2 ranks."""
    for d in dumps:
        sync = d.get("mpisync")
        if sync and sync.get("offsets_us"):
            return [float(o) for o in sync["offsets_us"]]
    return []


def corrected_events(dumps: List[dict],
                     offsets_us: List[float]) -> List[dict]:
    """Flatten dumps into events with clock-corrected microsecond
    timestamps relative to the earliest event (rank0 timebase):
    t_rank0 = t_remote - offset.  Ranks beyond the offset table (and
    daemon dumps, rank -1) pass through uncorrected."""
    out = []
    for d in dumps:
        rank = d["rank"]
        off_s = (offsets_us[rank] * 1e-6
                 if 0 <= rank < len(offsets_us) else 0.0)
        for ev in d["events"]:
            e = dict(ev)
            e["rank"] = rank
            e["ts"] = ev["ts"] - off_s
            out.append(e)
    if not out:
        return out
    base = min(e["ts"] for e in out)
    for e in out:
        e["ts"] = (e["ts"] - base) * 1e6           # us since first event
        if "dur" in e:
            e["dur"] = e["dur"] * 1e6
    out.sort(key=lambda e: e["ts"])
    return out


def chrome_trace(dumps: List[dict], offsets_us: List[float]) -> dict:
    """The Chrome trace-event document: pid = rank, tid = category."""
    events = corrected_events(dumps, offsets_us)
    cats = sorted({e["cat"] for e in events})
    tid_of = {c: i + 1 for i, c in enumerate(cats)}
    tev = []
    for d in dumps:
        tev.append({"ph": "M", "name": "process_name", "pid": d["rank"],
                    "tid": 0, "args": {"name": f"rank {d['rank']}"
                                       if d["rank"] >= 0 else "daemon"}})
        for c in cats:
            tev.append({"ph": "M", "name": "thread_name",
                        "pid": d["rank"], "tid": tid_of[c],
                        "args": {"name": c}})
    for e in events:
        ce = {"name": e["name"], "cat": e["cat"], "ph": e["ph"],
              "ts": round(e["ts"], 3), "pid": e["rank"],
              "tid": tid_of[e["cat"]], "args": e.get("args", {})}
        if e["ph"] == "X":
            ce["dur"] = round(e.get("dur", 0.0), 3)
        else:
            ce["s"] = "p"  # process-scoped instant
        tev.append(ce)
    meta = {d["rank"]: {"recorded": d.get("recorded"),
                        "dropped": d.get("dropped")} for d in dumps}
    return {"traceEvents": tev, "displayTimeUnit": "ms",
            "otherData": {"ranks": meta}}


def straggler_report(events: List[dict], top: int = 5) -> List[str]:
    """Correlated collective spans (cat coll/coll_dispatch, keyed by
    cid+seq): per instance the straggler is the member whose span
    STARTS last — everyone else was parked at the rendezvous waiting
    for it.  Aggregated into mean lateness per rank."""
    groups: Dict[tuple, List[dict]] = {}
    for e in events:
        if e["ph"] != "X" or e["cat"] not in ("coll", "coll_dispatch"):
            continue
        args = e.get("args", {})
        if "cid" not in args or "seq" not in args:
            continue
        groups.setdefault(
            (e["cat"], args["cid"], args["seq"]), []).append(e)
    late: Dict[int, List[float]] = {}
    for members in groups.values():
        if len(members) < 2:
            continue
        first = min(m["ts"] for m in members)
        for m in members:
            late.setdefault(m["rank"], []).append(m["ts"] - first)
    if not late:
        return ["  (no correlated multi-rank collective spans)"]
    rows = sorted(((sum(v) / len(v), max(v), r)
                   for r, v in late.items()), reverse=True)
    out = []
    for mean_us, max_us, r in rows[:top]:
        out.append(f"  rank {r}: mean lateness {mean_us:9.1f} us  "
                   f"max {max_us:9.1f} us  "
                   f"({len(late[r])} collectives)")
    return out


def request_phases(dumps: List[dict],
                   tid: int) -> Dict[int, Dict[str, float]]:
    """Per-rank per-category span time (us) inside this request's tag
    windows (DESIGN.md §23).  A rank's ``req_windows`` marks bracket
    each run — mark k opens window [ts_k, ts_{k+1}) — so every span
    the rank recorded in between belongs to the request whose 63-bit
    id the mark carries.  Containment is evaluated on the rank's OWN
    clock (marks and spans share a timebase), so no offset correction
    is needed here."""
    out: Dict[int, Dict[str, float]] = {}
    for d in dumps:
        rank = d.get("rank", -1)
        wins = d.get("req_windows") or []
        if rank < 0 or not wins:
            continue
        by_cat: Dict[str, float] = {}
        for k, w in enumerate(wins):
            if w.get("tag") != tid:
                continue
            t0 = w["ts"]
            t1 = wins[k + 1]["ts"] if k + 1 < len(wins) \
                else float("inf")
            for ev in d.get("events", ()):
                if ev.get("ph") != "X":
                    continue
                ts = ev.get("ts", 0.0)
                if t0 <= ts < t1:
                    cat = ev.get("cat", "?")
                    by_cat[cat] = (by_cat.get(cat, 0.0)
                                   + ev.get("dur", 0.0) * 1e6)
        if by_cat:
            out[rank] = by_cat
    return out


def job_report(dumps: List[dict], offsets_us: List[float],
               tid: int) -> tuple:
    """The per-request waterfall (DESIGN.md §23): the request's
    flight events — queue wait, park/resume gaps, per-run wall,
    checkpoint drain stalls, watchdog verdicts — merged and
    clock-corrected across every dump that carries them, plus
    per-phase span time from the rank request windows.  Returns
    ``(lines, info)`` where info carries the additive span sum the
    reqtrace probe compares against the client-measured wall:
    ``total_us = queued + sum(run walls) + sum(resume bringups)``
    (drain stalls overlap run wall and are reported, not summed)."""
    events = corrected_events(dumps, offsets_us)
    sids = {e["args"].get("sid") for e in events
            if e.get("args", {}).get("tid") == tid}
    req = []
    for e in events:
        a = e.get("args", {})
        name = e.get("name", "")
        if a.get("tid") == tid and (name.startswith("req_")
                                    or name == "wd_stall"):
            req.append(e)
        elif name == "req_drain" and a.get("band") in sids:
            # drain events are keyed by the cid-band (== sid): no tid
            # of their own, correlated through the session
            req.append(e)
    if not req:
        return [f"job 0x{tid:x}: no flight events in these dumps "
                "(was obs_reqtrace_enable on?)"], {}
    base = req[0]["ts"]
    q_us = run_us = resume_us = drain_us = 0
    runs = parks = stalls = 0
    lines = [f"request 0x{tid:x}  (session "
             + ",".join(f"s{s}" for s in sorted(sids)) + ")"]
    for e in req:
        a = e.get("args", {})
        t = e["ts"] - base
        name = e["name"]
        if name == "req_attach":
            q = a.get("queued_us", 0)
            q_us += q
            lines.append(f"  t+{t:12.0f}us  attach      "
                         f"queue wait {q}us")
        elif name == "req_run":
            runs += 1
            w = a.get("wall_ms", 0) * 1000
            run_us += w
            lines.append(f"  t+{t:12.0f}us  run #{runs:<3}    "
                         f"span {a.get('span')}  wall {w}us")
        elif name == "req_park":
            parks += 1
            lines.append(f"  t+{t:12.0f}us  park        "
                         "preempted (capacity reclaimed)")
        elif name == "req_resume":
            r = a.get("us", 0)
            resume_us += r
            lines.append(f"  t+{t:12.0f}us  resume      "
                         f"bringup {r}us")
        elif name == "req_drain":
            drain_us += a.get("us", 0)
            lines.append(f"  t+{t:12.0f}us  ckpt drain  "
                         f"epoch {a.get('epoch')}  "
                         f"stalled {a.get('us', 0)}us "
                         "(overlaps run)")
        elif name == "wd_stall":
            stalls += 1
            lines.append(f"  t+{t:12.0f}us  WD STALL    "
                         f"run {a.get('run_ms')}ms vs est "
                         f"{a.get('est_ms')}ms — tools/doctor.py "
                         "has the capture")
    phases = request_phases(dumps, tid)
    for rank in sorted(phases):
        parts = " ".join(f"{c}={int(v)}us" for c, v in
                         sorted(phases[rank].items(),
                                key=lambda cv: -cv[1]))
        lines.append(f"  r{rank:<3} in-request span time: {parts}")
    total = q_us + run_us + resume_us
    lines.append(f"  span sum {total}us  (queue {q_us}us + "
                 f"{runs} run(s) {run_us}us + {parks} park(s) "
                 f"resume {resume_us}us; drain stalls {drain_us}us "
                 "overlap)")
    info = {"tid": tid, "sids": sorted(sids), "runs": runs,
            "parks": parks, "stalls": stalls,
            "queued_us": q_us, "run_us": run_us,
            "resume_us": resume_us, "drain_us": drain_us,
            "total_us": total, "phases": phases}
    return lines, info


def _hist_percentiles(hist: List[int]) -> Dict[str, float]:
    """p50/p90/p99 (us) from a log2 latency histogram: bucket b holds
    [2^(b-1), 2^b) us (hist_add's bit_length bucketing), and the
    reported value is the bucket upper bound — the resolution the
    gauge actually has.  Kept stdlib-local so traceview stays
    runnable against dump files alone."""
    total = sum(hist)
    out: Dict[str, float] = {}
    if not total:
        return out
    for tag, q in (("p50", 0.50), ("p90", 0.90), ("p99", 0.99)):
        cum = 0
        for b, c in enumerate(hist):
            cum += c
            if cum >= q * total:
                out[tag] = float(1 << b)
                break
    return out


def hist_gauge_summary(dumps: List[dict],
                       metrics: Optional[dict] = None) -> List[str]:
    """Latency percentiles from the HISTOGRAM GAUGES rather than raw
    spans.  On always-sampled runs the adaptive sampler decimates the
    ring (slowest-span tables see a fraction of each category), but
    every operation lands in the histograms exactly once — so these
    lines stay truthful when the span tables cannot.  A metrics
    snapshot (the DVM ``metrics`` RPC reply, already aggregated
    across resident ranks) takes precedence; otherwise the per-rank
    dump histograms are summed."""
    agg: Dict[str, List[int]] = {}
    if metrics and metrics.get("hists"):
        for name, h in metrics["hists"].items():
            agg[name] = list(h)
    else:
        for d in dumps:
            for name, h in (d.get("hists") or {}).items():
                cur = agg.setdefault(name, [0] * len(h))
                for b, c in enumerate(h):
                    cur[b] += c
    lines = []
    for name in sorted(agg):
        p = _hist_percentiles(agg[name])
        if not p:
            continue
        lines.append(f"  {name:<16} p50 {p['p50']:>9.0f} us  "
                     f"p90 {p['p90']:>9.0f} us  "
                     f"p99 {p['p99']:>9.0f} us  "
                     f"(n={sum(agg[name])})")
    if not lines:
        return ["  (no histogram gauges in dumps or snapshot)"]
    return lines


def summary(dumps: List[dict], offsets_us: List[float],
            top: int = 5, metrics: Optional[dict] = None) -> str:
    events = corrected_events(dumps, offsets_us)
    lines = []
    total = sum(d.get("recorded", 0) for d in dumps)
    dropped = sum(d.get("dropped", 0) for d in dumps)
    lines.append(f"{len(dumps)} rank dump(s), {len(events)} events "
                 f"merged ({total} recorded, {dropped} dropped)")
    # sampling honesty: surface per-category drop accounting and any
    # rank whose adaptive sampler backed off to 1-in-N (N > 1), so a
    # sparse-looking merged timeline is never mistaken for a quiet run
    by_cat: Dict[str, int] = {}
    for d in dumps:
        for cat, n in (d.get("dropped_by_cat") or {}).items():
            by_cat[cat] = by_cat.get(cat, 0) + n
    if any(by_cat.values()):
        lines.append("dropped by category (sampled out or evicted): "
                     + " ".join(f"{c}={n}"
                                for c, n in sorted(by_cat.items())
                                if n))
    for d in dumps:
        rates = {c: p for c, p in (d.get("sampling") or {}).items()
                 if p > 1}
        if rates:
            lines.append(f"  rank {d['rank']} sampling 1-in-N: "
                         + " ".join(f"{c}:{p}"
                                    for c, p in sorted(rates.items())))
    spans = [e for e in events if e["ph"] == "X"]
    for cat in sorted({e["cat"] for e in spans}):
        lines.append(f"slowest {cat}:")
        worst = sorted((e for e in spans if e["cat"] == cat),
                       key=lambda e: -e.get("dur", 0.0))[:top]
        for e in worst:
            args = e.get("args", {})
            key = " ".join(f"{k}={v}" for k, v in sorted(args.items())
                           if k in ("cid", "seq", "mid", "nbytes"))
            lines.append(f"  r{e['rank']:<3} {e['name']:<20} "
                         f"{e.get('dur', 0.0):10.1f} us  {key}")
    lines.append("latency percentiles (histogram gauges"
                 + (", metrics snapshot" if metrics else "") + "):")
    lines.extend(hist_gauge_summary(dumps, metrics))
    lines.append("straggler ranks (latest to arrive at correlated "
                 "collectives):")
    lines.extend(straggler_report(events, top))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="traceview",
        description="Merge per-rank trace dumps into clock-corrected "
                    "Chrome trace-event JSON + a straggler summary")
    ap.add_argument("dumps", nargs="+",
                    help="per-rank trace dump files (globs ok)")
    ap.add_argument("--sync", default=None,
                    help="mpisync JSON (offsets_us) for clock "
                         "correction (overrides the offsets embedded "
                         "in the dumps at finalize)")
    ap.add_argument("-o", "--out", default=None,
                    help="write Chrome trace-event JSON here")
    ap.add_argument("--top", type=int, default=5,
                    help="rows per summary section")
    ap.add_argument("--job", default=None, metavar="TID",
                    help="render the per-request waterfall for this "
                         "trace id (hex 0x... or decimal) instead of "
                         "the category summary: queue wait, "
                         "park/resume gaps, per-run wall, drain "
                         "stalls, per-rank in-request span time")
    ap.add_argument("--metrics", default=None,
                    help="a metrics-RPC snapshot JSON (DvmClient."
                         "metrics() reply): its aggregated histogram "
                         "gauges feed the percentile summary, so "
                         "summaries work on decimated/always-sampled "
                         "dumps")
    opts = ap.parse_args(argv)

    dumps = load_dumps(opts.dumps)
    offsets = load_offsets(opts.sync) if opts.sync \
        else embedded_offsets(dumps)
    if opts.job:
        try:
            tid = int(opts.job, 0)
        except ValueError:
            sys.stderr.write(f"traceview: bad --job id "
                             f"{opts.job!r} (hex 0x... or decimal)\n")
            return 2
        lines, info = job_report(dumps, offsets, tid)
        sys.stdout.write("\n".join(lines) + "\n")
        return 0 if info else 1
    metrics = None
    if opts.metrics:
        with open(opts.metrics) as fh:
            metrics = json.load(fh)
    if opts.out:
        doc = chrome_trace(dumps, offsets)
        with open(opts.out, "w") as fh:
            json.dump(doc, fh)
        sys.stderr.write(
            f"wrote {len(doc['traceEvents'])} trace events to "
            f"{opts.out}\n")
    sys.stdout.write(summary(dumps, offsets, top=opts.top,
                             metrics=metrics) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
