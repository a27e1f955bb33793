"""device_idle_pct: the share of the traced window in which no kernel
or copy ran on the card (the mean over the cards used), in %."""


def read(run):
    if run.dev is None or run.dev.n_events == 0 or run.dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.dev.busy_s / run.dev.window_s)
