#!/usr/bin/env python3
"""The readings a cell's correctness limits are set from, in one process.

    python3 portbench/readings.py --workload <cell> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 2] [--out FILE] [--cpu --scale N]

For each of ``--seeds`` it runs the cell as ``run.py`` does, with a
short window at the cell's own load, and reads the numbers compared
(the program's readings: the lower end of each limit).  For each of
``--control-seeds`` it makes the same inputs and puts the control in
the program's place: the plain reference computed one precision down
(``check.control_kept``), every rank's output of the first buffer
stamped with the first row, judged by the same comparison (the upper
end).  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import json
import os
import sys
import time


def main(argv) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="portbench/readings.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--scale", type=int, default=256)
    a = ap.parse_args(argv)
    from portbench import check, harness, spec, traffic
    cell = spec.resolve(a.workload)
    if not a.cpu:
        why = harness._check_cards(cell.chips)
        if why:
            print(f"readings: {why}", file=sys.stderr)
            return 2
    seeds = [int(s) for s in a.seeds.split(",") if s]
    cseeds = [int(s) for s in a.control_seeds.split(",") if s]
    doc = {"workload": a.workload, "program": {}, "control": {}}
    for s in seeds:
        t0 = time.perf_counter()
        run, info, numbers, nkept = harness.execute(
            cell, s, a.seconds, False, a.cpu, a.scale, t0)
        doc["program"][str(s)] = dict(numbers, kept=nkept,
                                      steps=len(run.steps_ns))
        print(f"program seed {s}: {numbers} ({nkept} outputs, "
              f"{len(run.steps_ns)} steps)", flush=True)
    if cseeds:
        mix = traffic.Mix.from_dict(cell.traffic_name, cell.traffic,
                                    a.scale if a.cpu else 1)
        n = int(cell.config["ranks"])
        devs = [getattr(d, "device", d)
                for d in harness._devices(cell.config, a.cpu)]
        for s in cseeds:
            sends = [traffic.make_inputs(mix, s, r, devs[r]) for r in range(n)]
            stamps = [traffic.Stamps(mix, s, r, devs[r]) for r in range(n)]
            kept = check.control_kept(mix, sends, stamps, range(n), [0], devs)
            numbers = check.compare(mix, sends, stamps, kept)
            doc["control"][str(s)] = numbers
            print(f"control seed {s}: {numbers}", flush=True)
            del sends, stamps, kept
    for side in ("program", "control"):
        rows = doc[side].values()
        if rows:
            doc[side + "_max_err"] = [min(r["max_err"] for r in rows),
                                      max(r["max_err"] for r in rows)]
    if a.out:
        os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
        with open(a.out, "w") as fh:
            json.dump(doc, fh, indent=1)
    print(json.dumps({k: v for k, v in doc.items() if k.endswith("max_err")}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.exit(main(sys.argv[1:]))
