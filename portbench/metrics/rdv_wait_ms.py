"""rdv_wait_ms: a rank's wait in the meeting (coll/device.py: the
port's ``ph_rdv_wait`` phase spans) an op, in ms: the mean over the
traced ops of the window and the ranks.  The port fences a traced op's
body on the card (its ``ph_execute`` span) while the other ranks wait
for its result; that fence exists only in a traced op, so the part of
a wait that overlaps its op's ``ph_execute`` is not counted.  Nothing
when the port traced no such span, or its ring lost events."""


def read(run):
    if not run.phases or run.phase_lost:
        return None
    fence = {}
    for ph in run.phases:
        for s, e, op in (ph or {}).get("ph_execute", ()):
            fence.setdefault(op, []).append((s, e))
    waits = {}
    for r, ph in enumerate(run.phases):
        for s, e, op in (ph or {}).get("ph_rdv_wait", ()):
            inside = sum(max(0, min(e, fe) - max(s, fs))
                         for fs, fe in fence.get(op, ()))
            waits[r, op] = waits.get((r, op), 0) + (e - s - inside)
    if not waits:
        return None
    return sum(waits.values()) * 1e-6 / len(waits)
