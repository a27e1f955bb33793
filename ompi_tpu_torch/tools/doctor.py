"""doctor: reduce a hang-doctor capture to a verdict.

Port of the reference's ``ompi_tpu/tools/doctor.py``, whole.  A capture
is a JSON document per stalled session — every resident rank's stack,
the session world's rendezvous arrival state, its KV namespace's
in-flight fences, the abort state, the flight-recorder tail, the
health plane's host rows, the integrity convictions and the ranks'
placement.  In the port ``testing.sessions.doctor_capture`` builds one
from a thread world, and the resident pool's watchdog (tools/dvm.py)
writes them as ``<uri>.doctor.s<sid>.json``, as the reference's does.
This tool reads captures and answers the only
question the operator has at 3am: *which rank is absent from which
rendezvous*, or *who never arrived at which fence*, with the
run-vs-estimate numbers and the last flight events as supporting
evidence.

Usage:
    python -m ompi_tpu_torch.tools.doctor <capture.json | uri_file>
        [--job TID] [--events N] [--stacks]

Pointing at a uri file globs every ``<uri>.doctor.s*.json`` next to
it; ``--job`` filters to the capture(s) whose request trace id
matches (hex ``0x...`` or decimal, ``obs.reqtrace``'s forms).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List


def load_captures(target: str) -> List[dict]:
    """Capture documents for whatever the operator pointed at: one
    JSON file, or a DVM uri file with ``<uri>.doctor.s*.json``
    siblings (sorted by sid so multi-stall output is stable)."""
    if os.path.isfile(target):
        with open(target) as fh:
            head = fh.read(1)
        if head == "{":
            with open(target) as fh:
                doc = json.load(fh)
            if "sid" in doc and "rendezvous" in doc:
                return [doc]
        # not a capture: treat as a uri file and glob its siblings
    paths = sorted(glob.glob(glob.escape(target) + ".doctor.s*.json"))
    docs = []
    for p in paths:
        try:
            with open(p) as fh:
                docs.append(json.load(fh))
        except (OSError, ValueError) as e:
            sys.stderr.write(f"doctor: skipping {p}: {e}\n")
    docs.sort(key=lambda d: d.get("sid", 0))
    return docs


def _match_job(doc: dict, job: str) -> bool:
    from ompi_tpu_torch.obs import reqtrace as _reqtrace
    try:
        want = _reqtrace.parse(job)
    except ValueError:
        return False
    return int(doc.get("tid") or 0) == want


def _rdv_lines(doc: dict) -> List[str]:
    """One line per partially-arrived rendezvous: who is there, who
    is not.  The absent ranks ARE the verdict — everyone listed as
    arrived is parked waiting for them."""
    out = []
    for rv in doc.get("rendezvous", ()):
        absent = rv.get("absent", [])
        arrived = rv.get("arrived", [])
        group = rv.get("group") or []

        def names(slots):
            return ",".join(str(group[s]) if s < len(group) else f"?{s}"
                            for s in slots) or "-"

        out.append(
            f"  rendezvous cid={rv.get('cid')} gen={rv.get('gen')}: "
            f"{rv.get('count')}/{rv.get('size')} arrived  "
            f"waiting ranks [{names(arrived)}]  "
            f"ABSENT ranks [{names(absent)}]")
    return out


def _fence_lines(doc: dict) -> List[str]:
    """One line per in-flight KV fence: arrival weight so far and the
    contributors seen, so the missing participant is the one NOT in
    the arrivals map."""
    out = []
    for fid, st in sorted((doc.get("fences") or {}).items()):
        arrivals = st.get("arrivals") or {}
        who = ",".join(f"{c}:{w}" for c, w in sorted(arrivals.items()))
        out.append(
            f"  fence {fid}: weight {st.get('arrived_weight')} arrived "
            f"({st.get('waiters', 0)} waiter(s) parked)  "
            f"contributors [{who or '-'}]")
    return out


def _straggler_lines(doc: dict) -> List[str]:
    """Gray-failure discrimination (DESIGN.md §24): the capture
    carries the pool's per-host health rows and the session's rank
    placement.  A session stalled with ranks resident on a host the
    health plane already scores sick is a STRAGGLER case — the ranks
    are arriving (just consistently last), so the absent-rank
    diagnosis would be wrong and the fix is migration, not blame."""
    rows = doc.get("host_health") or []
    placement = doc.get("placement") or []
    out: List[str] = []
    for row in rows:
        state = row.get("state", "healthy")
        if state == "healthy" or row.get("excluded"):
            continue
        host = row.get("host")
        ranks = [r for r, h in enumerate(placement) if h == host]
        if not ranks:
            continue
        sig = ",".join(row.get("signals") or []) or "beat"
        out.append(
            f"  host {host} is {state} (health score "
            f"{row.get('score')}, signals [{sig}]) — resident "
            f"rank(s) [{','.join(str(r) for r in ranks)}] are "
            f"arriving but consistently last")
    return out


def _sdc_lines(doc: dict) -> List[str]:
    """Silent-data-corruption attribution (DESIGN.md §25): the
    capture carries the pool's integrity-conviction rows.  A convicted
    chip names itself — the operator's fix is to keep the host
    quarantined (and RMA the chip), not to debug the model."""
    out: List[str] = []
    for rec in doc.get("sdc") or []:
        out.append(
            f"  CONVICTED: rank {rec.get('rank')} on host "
            f"{rec.get('host')} (comm cid={rec.get('cid')}, op "
            f"{rec.get('kind')}) produced a corrupt collective "
            f"operand — detected by the integrity plane, op retried "
            f"on pristine operands")
    return out


def verdict(doc: dict) -> List[str]:
    """The reduced diagnosis for one capture, most specific evidence
    first.  Pure (testable on a dict); returns printable lines."""
    from ompi_tpu_torch.obs import reqtrace as _reqtrace
    tid = int(doc.get("tid") or 0)
    job = f"  job {_reqtrace.fmt(tid)}" if tid else ""
    lines = [
        f"session s{doc.get('sid')}{job}  np {doc.get('np')}  "
        f"ns {doc.get('ns')}",
        f"  stalled: run {doc.get('run_ms')}ms vs pool estimate "
        f"{doc.get('est_ms')}ms (threshold {doc.get('factor_pct')}% "
        f"of estimate); detected {doc.get('mttd_ms')}ms past "
        f"threshold",
    ]
    if doc.get("aborted"):
        lines.append(
            f"  ULFM: world already carries aborted ranks "
            f"{doc['aborted']} — the stall is downstream of a fault")
    sdc = _sdc_lines(doc)
    if sdc:
        lines.append("SDC VERDICT: the integrity plane convicted "
                     "corrupting chip(s) — quarantine is the fix, "
                     "results were already repaired by retry:")
        lines.extend(sdc)
    rdv = _rdv_lines(doc)
    fen = _fence_lines(doc)
    if rdv:
        lines.append("VERDICT: rank(s) absent from an in-flight "
                     "rendezvous — everyone else is parked waiting:")
        lines.extend(rdv)
        straggler = _straggler_lines(doc)
        if straggler:
            lines.append("  (gray-failure context: the absent "
                         "rank(s) may be STRAGGLING, not dead —)")
            lines.extend(straggler)
    if fen:
        if not rdv:
            lines.append("VERDICT: in-flight KV fence(s) never "
                         "completed — a contributor never arrived:")
        else:
            lines.append("  (in-flight fences in the session "
                         "namespace:)")
        lines.extend(fen)
    if not rdv and not fen:
        straggler = _straggler_lines(doc)
        if straggler:
            lines.append(
                "VERDICT: straggler — rank(s) on a degraded host ARE "
                "arriving, just last every time; migrate the session "
                "(or quarantine the host), don't hunt for an absent "
                "rank:")
            lines.extend(straggler)
        else:
            lines.append(
                "VERDICT: no partially-arrived rendezvous or "
                "in-flight fence — the session is slow inside local "
                "compute (see stacks), not blocked on a peer")
    nstk = len(doc.get("stacks") or {})
    if nstk:
        lines.append(f"  {nstk} rank stack(s) captured "
                     f"(--stacks to print)")
    return lines


def stack_lines(doc: dict) -> List[str]:
    out = []
    for name, frames in sorted((doc.get("stacks") or {}).items()):
        out.append(f"  -- {name} --")
        for f in frames[-6:]:
            out.extend("    " + ln for ln in f.rstrip().splitlines())
    return out


def event_lines(doc: dict, last: int) -> List[str]:
    evs = doc.get("events") or []
    out = [f"  flight recorder (last {min(last, len(evs))} of "
           f"{len(evs)} captured):"]
    for ev in evs[-last:]:
        args = " ".join(f"{k}={v}"
                        for k, v in (ev.get("args") or {}).items())
        rank = ev.get("rank", -1)
        who = f"r{rank}" if rank >= 0 else "pool"
        out.append(f"    {ev.get('ts', 0.0):.3f} {who:>5} "
                   f"{ev.get('name', '?'):<18} {args}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ompi_tpu_torch-doctor",
        description="Reduce hang-doctor captures to a verdict: which "
                    "rank is absent from which rendezvous or fence")
    ap.add_argument("target",
                    help="a doctor capture JSON, or a DVM uri file "
                         "(globs <uri>.doctor.s*.json)")
    ap.add_argument("--job", default=None, metavar="TID",
                    help="only captures for this request trace id "
                         "(hex 0x... or decimal)")
    ap.add_argument("--events", type=int, default=8, metavar="N",
                    help="flight-recorder events per capture "
                         "(default 8, 0 to omit)")
    ap.add_argument("--stacks", action="store_true",
                    help="print the captured rank stacks")
    opts = ap.parse_args(argv)

    docs = load_captures(opts.target)
    if opts.job:
        docs = [d for d in docs if _match_job(d, opts.job)]
    if not docs:
        sys.stderr.write(
            f"doctor: no capture(s) at {opts.target}"
            + (f" for job {opts.job}" if opts.job else "")
            + " — is the watchdog armed (obs_watchdog_ms)?\n")
        return 1
    for i, doc in enumerate(docs):
        if i:
            sys.stdout.write("\n")
        sys.stdout.write("\n".join(verdict(doc)) + "\n")
        if opts.events > 0:
            sys.stdout.write("\n".join(event_lines(doc, opts.events))
                             + "\n")
        if opts.stacks:
            sys.stdout.write("\n".join(stack_lines(doc)) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
