"""busbw_GBps: bus bytes of every op completed in the window over the
window's time (first step's start to the last step's end, its
synchronize included), in GB/s (1e9 bytes a second)."""

from portbench.yardstick import busbw_GBps


def read(run):
    return busbw_GBps(run.ops, run.bus_bytes_per_op, run.window_ns)
