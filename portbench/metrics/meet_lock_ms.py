"""meet_lock_ms: a rank's time taking the meeting's lock an op
(coll/device.py ``Rendezvous.begin`` and ``finish``: the port's
``meet_lock`` spans, one each), in ms: for each op and rank the sum of
its ``meet_lock`` spans, the mean over the window's ops and ranks.  A
rank queues on the lock behind the others and behind a body the
trigger runs inline under it.  Nothing where the port records no such
span, or its rings lost events."""

from portbench import meetspans


def read(run):
    got = meetspans.spans(run)
    if not got:
        return None
    held = {}
    for r, per in enumerate(got):
        for s, e, op, _ in per["meet_lock"]:
            held[r, op] = held.get((r, op), 0) + (e - s)
    if not held:
        return None
    return sum(held.values()) * 1e-6 / len(held)
