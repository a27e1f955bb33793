"""meet_wake_ms: how long after a meeting posts its results a waiting
member leaves its wait, in ms.  For each op (its ``meet_post``) and
each rank whose ``finish`` wait (the rank's last ``meet_wait`` or
``ph_rdv_wait`` of the op) began before the post: the wait's end less
the post; the mean of these.  The part of ``rdv_wait_ms`` that is not
waiting for peers: the trigger's rest under the lock, one
``notify_all`` and the members' turns on the lock.  Nothing where the
port records no such span, or its rings lost events."""

from portbench import meetspans


def read(run):
    got = meetspans.spans(run)
    if not got:
        return None
    post = {}
    for per in got:
        for s, _, op, _ in per["meet_post"]:
            post[op] = s
    wakes = []
    for per in got:
        last = {}
        for name in ("meet_wait", "ph_rdv_wait"):
            for s, e, op, _ in per[name]:
                if op not in last or s > last[op][0]:
                    last[op] = (s, e)
        for op, (s, e) in last.items():
            p = post.get(op)
            if p is not None and s < p:
                wakes.append(e - p)
    if not wakes:
        return None
    return sum(wakes) * 1e-6 / len(wakes)
