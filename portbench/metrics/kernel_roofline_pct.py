"""kernel_roofline_pct: the least device time of the window's ops (the
collective's own bytes at the card's published rates, yardstick.py)
over the card's busy time in the traced window, every kernel and copy
counted whatever its name; the mean over the cards used, in %.
Nothing without a device trace, a busy card or a known peak."""


def read(run):
    if run.dev is None or run.least_s is None or run.dev.busy_s <= 0:
        return None
    return 100.0 * run.ops * run.least_s / run.dev.busy_s
