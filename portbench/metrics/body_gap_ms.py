"""body_gap_ms: how long the card waited for each meeting, in ms.  For
each op's body on the card (the port's ``meet_device``: a CUDA event
recorded on the body's stream just before its first launch and its
done event, put on the host clock), the time from the previous body's
end on the same card to its start, 0 where it queued behind it; the
mean over the window's ops that follow another.  The card waits for
the meeting and for the body's host work before its launch alike.
Ops × this is the card's idle time between bodies.  Nothing where the
port records no such span, or its rings lost events."""

from portbench import meetspans


def read(run):
    got = meetspans.spans(run)
    if not got:
        return None
    cards = {}
    for per in got:
        for s, e, _, card in per["meet_device"]:
            cards.setdefault(card, []).append((s, e))
    gaps = []
    for bodies in cards.values():
        bodies.sort()
        for (_, e0), (s1, _) in zip(bodies, bodies[1:]):
            gaps.append(max(0, s1 - e0))
    if not gaps:
        return None
    return sum(gaps) * 1e-6 / len(gaps)
