"""critpath: cross-rank critical-path analysis of phase-profiled dumps.

traceview merges per-rank dumps into one timeline; this tool answers
the question traceview cannot: **which rank's which phase gated each
collective, and where does the dispatch tax actually go?**  It
consumes the same per-rank JSON dumps (with the sub-op phase spans the
phase profiler records under ``trace_phase_enable``, DESIGN.md §18)
and emits:

  * a **gating table** — per correlated multi-rank op (cid+seq key,
    the device-tier sequence every member ticks in lockstep), the
    member whose span starts LAST is the gate: everyone else was
    parked at the rendezvous waiting for it.  The gate's own largest
    contained phase names WHY it was late, unless the arrival skew
    exceeds every phase it recorded — then the op was arrival-gated
    and the verdict is ``rendezvous`` (an upstream straggler, e.g. an
    injected delay or a slow host, not a slow dispatch).
  * a **dispatch-tax report** — per (algorithm, pow2 size bucket),
    the median microseconds each phase (rendezvous / pack / dispatch /
    execute / unpack / compile) contributes, from the phase spans
    time-contained in each whole-op dispatch span.
  * a **coverage figure** — the fraction of op wall time attributed
    to named phases (clipped per op so overlapping waits never count
    twice); the acceptance bar is >= 0.90 on a phase-profiled run.
  * optionally (``-o``) the traceview Chrome trace with **flow
    arrows** stitched in: one arrow per multi-rank op from the gating
    member's span start to every waiter's span end — perfetto renders
    the blocking chain directly.

Clock correction reuses traceview's loaders: explicit ``--sync``
mpisync JSON wins, else the offsets auto-embedded in the dumps at
finalize, else raw clocks (thread-rank worlds share one clock).

Usage:

    python -m ompi_tpu_torch.tools.critpath trace-r*.json \
        [--sync mpisync.json] [-o stitched.json] [--top 5] [--json]

Stdlib-only on purpose (like traceview): runnable against dump files
alone, no live runtime needed.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch.tools import traceview

# span name -> phase label (mirrors trace.PHASE_LABELS; copied so the
# tool keeps working against dump files with no package state)
PHASE_OF = {
    "ph_rdv_wait": "rendezvous",
    "ph_pack": "pack",
    "fused_pack": "pack",
    "ph_dispatch": "dispatch",
    "ph_execute": "execute",
    "ph_unpack": "unpack",
    "xla_compile": "compile",
    "kernel_load": "compile",
}

#: categories whose spans are whole-op records correlated across ranks
#: by the (cid, seq) key every member ticks in lockstep
OP_CATS = ("coll", "coll_dispatch", "coll_segment")

#: categories whose spans are sub-op phase records
PHASE_CATS = ("phase", "compile")


def _spans(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X"]


def group_ops(events: List[dict]) -> Dict[tuple, List[dict]]:
    """Correlate whole-op spans across ranks.

    Device-tier collectives group on ``(cat, cid, seq)`` — the per-comm
    device sequence number ticks on every op/segment on every member,
    sampled out or not, so surviving spans keep aligned keys.  p2p
    spans group on the ob1 match id ``mid`` (identical on sender and
    receiver)."""
    groups: Dict[tuple, List[dict]] = {}
    for e in _spans(events):
        cat = e.get("cat")
        args = e.get("args") or {}
        if cat in OP_CATS and "cid" in args and "seq" in args:
            groups.setdefault(
                (cat, e["name"], args["cid"], args["seq"]), []).append(e)
        elif cat == "p2p" and "mid" in args:
            groups.setdefault(("p2p", args["mid"]), []).append(e)
    return groups


def phase_index(events: List[dict]) -> Dict[int, List[dict]]:
    """Per-rank phase spans sorted by start time."""
    idx: Dict[int, List[dict]] = {}
    for e in _spans(events):
        if e.get("cat") in PHASE_CATS and e["name"] in PHASE_OF:
            idx.setdefault(e["rank"], []).append(e)
    for lst in idx.values():
        lst.sort(key=lambda e: e["ts"])
    return idx


def contained_phases(op: dict, idx: Dict[int, List[dict]],
                     slack_us: float = 1.0) -> List[dict]:
    """Phase spans on the op's rank that overlap the op's window
    (start within [ts - slack, ts + dur + slack]).  Overlap rather
    than strict containment: a finish-side rendezvous wait may close a
    hair after the op span's own end timestamp."""
    lo = op["ts"] - slack_us
    hi = op["ts"] + op.get("dur", 0.0) + slack_us
    out = []
    for e in idx.get(op["rank"], ()):
        if e["ts"] > hi:
            break
        if e["ts"] >= lo and e["ts"] + e.get("dur", 0.0) <= hi + slack_us:
            out.append(e)
    return out


def _clipped_phase_us(op: dict, phases: List[dict]) -> float:
    """Wall time inside the op window attributed to phases, clipped to
    the window and capped at the op duration (a gate rank's finish
    wait overlaps its own dispatch+execute — attribution must never
    exceed 100% of the op)."""
    lo = op["ts"]
    hi = lo + op.get("dur", 0.0)
    total = 0.0
    for e in phases:
        a = max(lo, e["ts"])
        b = min(hi, e["ts"] + e.get("dur", 0.0))
        if b > a:
            total += b - a
    return min(total, op.get("dur", 0.0))


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    if not n:
        return 0.0
    m = n // 2
    return s[m] if n % 2 else 0.5 * (s[m - 1] + s[m])


def _pow2_bucket(nbytes: int) -> int:
    if nbytes <= 0:
        return 0
    return 1 << max(0, int(nbytes) - 1).bit_length()


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 30:
        return f"{n >> 30}GiB"
    if n >= 1 << 20:
        return f"{n >> 20}MiB"
    if n >= 1 << 10:
        return f"{n >> 10}KiB"
    return f"{n}B"


def _op_alg(op: dict) -> Optional[str]:
    """Algorithm label of a whole-op dispatch span, or None when the
    span is not an (alg, size) context (segment spans ride inside a
    pipeline_* span that already carries the algorithm)."""
    name = op["name"]
    if name == "meet":
        return "fused"
    if name.startswith("pipeline_"):
        alg = (op.get("args") or {}).get("alg")
        return alg if isinstance(alg, str) else None
    return None


def dispatch_tax(events: List[dict],
                 idx: Dict[int, List[dict]]) -> Dict[str, Dict[str, float]]:
    """Median us per phase per (algorithm, pow2-size) — the measured
    answer to "where does a segmented op's time actually go"."""
    acc: Dict[Tuple[str, int], Dict[str, List[float]]] = {}
    for op in _spans(events):
        if op.get("cat") != "coll_dispatch":
            continue
        alg = _op_alg(op)
        if alg is None:
            continue
        nbytes = (op.get("args") or {}).get("nbytes", 0)
        key = (alg, _pow2_bucket(int(nbytes or 0)))
        per = acc.setdefault(key, {})
        for e in contained_phases(op, idx):
            per.setdefault(PHASE_OF[e["name"]], []).append(
                e.get("dur", 0.0))
    out: Dict[str, Dict[str, float]] = {}
    for (alg, size), per in sorted(acc.items()):
        row = {ph: round(_median(v), 1) for ph, v in sorted(per.items())}
        out[f"{alg} {_fmt_bytes(size)}"] = row
    return out


def _gate_of(members: List[dict]) -> Tuple[dict, float]:
    """(gating member, arrival skew us): the member whose span starts
    last held everyone else at the rendezvous."""
    first = min(m["ts"] for m in members)
    gate = max(members, key=lambda m: m["ts"])
    return gate, gate["ts"] - first


def gating_verdict(gate: dict, skew_us: float,
                   idx: Dict[int, List[dict]]) -> str:
    """Name WHY the gate was last: its largest contained phase — or
    ``rendezvous`` when the arrival skew dwarfs everything it recorded
    (the delay happened upstream of the op: the op was arrival-gated,
    not dispatch-gated)."""
    best = None
    best_dur = 0.0
    for e in contained_phases(gate, idx):
        d = e.get("dur", 0.0)
        if d > best_dur:
            best, best_dur = e, d
    if best is not None and best_dur >= skew_us:
        return PHASE_OF[best["name"]]
    return "rendezvous"


def analyze(dumps: List[dict], offsets_us: List[float],
            min_skew_us: float = 0.0) -> Dict[str, Any]:
    """The full critical-path analysis document."""
    events = traceview.corrected_events(dumps, offsets_us)
    idx = phase_index(events)
    groups = group_ops(events)

    gating: Dict[str, int] = {}
    skews: List[float] = []
    multi = 0
    for key, members in groups.items():
        ranks = {m["rank"] for m in members}
        if len(ranks) < 2:
            continue
        multi += 1
        gate, skew = _gate_of(members)
        skews.append(skew)
        if skew < min_skew_us:
            continue
        verdict = gating_verdict(gate, skew, idx)
        gkey = f"r{gate['rank']}:{verdict}"
        gating[gkey] = gating.get(gkey, 0) + 1

    # coverage over whole-op spans that HAVE a phase-profiled window:
    # meet/seg_meet (per-op, per-segment) — pipeline_* wraps the same
    # wall time again and would double the denominator
    op_wall = 0.0
    attributed = 0.0
    ops = 0
    for op in _spans(events):
        if op.get("cat") not in ("coll_dispatch", "coll_segment"):
            continue
        if op["name"].startswith("pipeline_"):
            continue
        ops += 1
        op_wall += op.get("dur", 0.0)
        attributed += _clipped_phase_us(
            op, contained_phases(op, idx))

    skews.sort()
    n = len(skews)
    return {
        "ops": ops,
        "multi_rank_ops": multi,
        "coverage": round(attributed / op_wall, 4) if op_wall else 0.0,
        "gating": dict(sorted(gating.items(),
                              key=lambda kv: -kv[1])),
        "skew_us": {
            "p50": round(skews[n // 2], 1) if n else 0.0,
            "p90": round(skews[min(n - 1, int(n * 0.9))], 1) if n else 0.0,
            "max": round(skews[-1], 1) if n else 0.0,
        },
        "phase_wall_us": {
            ph: round(sum(e.get("dur", 0.0) for lst in idx.values()
                          for e in lst if PHASE_OF[e["name"]] == ph), 1)
            for ph in sorted({PHASE_OF[e["name"]]
                              for lst in idx.values() for e in lst})
        },
        "tax": dispatch_tax(events, idx),
    }


def stitched_chrome_trace(dumps: List[dict],
                          offsets_us: List[float]) -> dict:
    """traceview's Chrome trace plus perfetto flow arrows: one arrow
    per multi-rank op from the gating member's span START (the moment
    the stall broke) to every waiter's span END (the moment each
    waiter got released)."""
    doc = traceview.chrome_trace(dumps, offsets_us)
    events = traceview.corrected_events(dumps, offsets_us)
    cats = sorted({e["cat"] for e in events})
    tid_of = {c: i + 1 for i, c in enumerate(cats)}
    flow_id = 0
    for key, members in sorted(group_ops(events).items(),
                               key=lambda kv: str(kv[0])):
        if len({m["rank"] for m in members}) < 2:
            continue
        gate, _skew = _gate_of(members)
        flow_id += 1
        doc["traceEvents"].append(
            {"ph": "s", "id": flow_id, "name": "critpath",
             "cat": "critpath", "pid": gate["rank"],
             "tid": tid_of[gate["cat"]], "ts": round(gate["ts"], 3)})
        for m in members:
            if m is gate:
                continue
            doc["traceEvents"].append(
                {"ph": "f", "bp": "e", "id": flow_id, "name": "critpath",
                 "cat": "critpath", "pid": m["rank"],
                 "tid": tid_of[m["cat"]],
                 "ts": round(m["ts"] + m.get("dur", 0.0), 3)})
    return doc


def report(res: Dict[str, Any], top: int = 5) -> str:
    lines = []
    lines.append(
        f"{res['ops']} phase-profiled op span(s), "
        f"{res['multi_rank_ops']} correlated multi-rank op(s), "
        f"coverage {res['coverage'] * 100:.1f}% of op wall time "
        f"attributed to named phases")
    sk = res["skew_us"]
    lines.append(f"arrival skew: p50 {sk['p50']} us  p90 {sk['p90']} us"
                 f"  max {sk['max']} us")
    lines.append("gating (rank:phase, ops gated):")
    rows = list(res["gating"].items())[:top]
    if not rows:
        lines.append("  (no multi-rank ops — single rank dump, or "
                     "phase profiling was off)")
    for k, v in rows:
        lines.append(f"  {k:<24} {v}")
    lines.append("phase wall time (us, all ranks):")
    for ph, us in sorted(res["phase_wall_us"].items(),
                         key=lambda kv: -kv[1]):
        lines.append(f"  {ph:<12} {us:12.1f}")
    lines.append("dispatch tax (median us per phase per alg x size):")
    if not res["tax"]:
        lines.append("  (no whole-op dispatch spans with phases)")
    for ctx, row in res["tax"].items():
        cells = "  ".join(f"{ph}={us}" for ph, us in row.items())
        lines.append(f"  {ctx:<20} {cells}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="critpath",
        description="Cross-rank critical-path analysis: gating "
                    "(rank, phase) per collective + dispatch-tax "
                    "report from phase-profiled trace dumps")
    ap.add_argument("dumps", nargs="+",
                    help="per-rank trace dump files (globs ok)")
    ap.add_argument("--sync", default=None,
                    help="mpisync JSON (offsets_us); default: offsets "
                         "embedded in the dumps at finalize")
    ap.add_argument("-o", "--out", default=None,
                    help="write the flow-arrow-stitched Chrome trace "
                         "JSON here")
    ap.add_argument("--top", type=int, default=5,
                    help="rows in the gating table")
    ap.add_argument("--json", action="store_true",
                    help="emit the analysis document as JSON instead "
                         "of the text report")
    opts = ap.parse_args(argv)

    dumps = traceview.load_dumps(opts.dumps)
    offsets = traceview.load_offsets(opts.sync) if opts.sync \
        else traceview.embedded_offsets(dumps)
    res = analyze(dumps, offsets)
    if opts.out:
        doc = stitched_chrome_trace(dumps, offsets)
        with open(opts.out, "w") as fh:
            json.dump(doc, fh)
        sys.stderr.write(
            f"wrote {len(doc['traceEvents'])} trace events "
            f"(flow arrows included) to {opts.out}\n")
    if opts.json:
        sys.stdout.write(json.dumps(res, indent=2) + "\n")
    else:
        sys.stdout.write(report(res, top=opts.top) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
