"""busbw_traced_GBps: ``busbw_GBps`` as the --trace 1 run reads it, with
the port's phase tracing and the profiler on.  Beside the untraced
run's ``busbw_GBps`` it says how far tracing slowed the run that the
other per-layer metrics describe."""

from portbench.yardstick import busbw_GBps


def read(run):
    if run.dev is None:
        return None
    return busbw_GBps(run.ops, run.bus_bytes_per_op, run.window_ns)
