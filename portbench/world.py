"""One cell's thread world: set-up, the measured window, the kept outputs.

The configuration's ranks run as threads of this process through the
port's launcher (``ompi_tpu_torch.testing.run_ranks``), rank r on
``cuda:(r % cards)``.  A step is a closed loop: every rank makes
``ops_per_step`` blocking calls, op j of step k on send buffer
(j + k) % buffers, and then synchronizes its card.  The first rank to
reach step k decides for every rank whether it runs (the window's
seconds not yet spent), so the ranks agree without a meeting.  Before
each op the rank stamps the op's send buffer with the next row of its
stamp table (``traffic.Stamps``), warm-up ops included.

Each rank keeps the outputs of two steps for the check: the latest, and
one drawn from the seed (step k replaces the drawn one with chance
1/(k+1), so each step of the window is equally likely).  A step lets go
of the step before it as it starts, so the outputs alive at once are
those of the running step and the drawn one.  A vector
layout unpacks into receive spans in place, so a drawn step writes into
a spare set of spans.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import torch

from portbench import traffic
from portbench.traffic import Caller, Mix

_now = time.perf_counter_ns


class Gate:
    """Which steps run: decided once a step, by the first rank there."""

    def __init__(self, seconds: float) -> None:
        self.seconds_ns = int(seconds * 1e9)
        self.t0: Optional[int] = None
        self._go: List[bool] = []
        self._lock = threading.Lock()

    def go(self, k: int) -> bool:
        with self._lock:
            if k == len(self._go):
                now = _now()
                if self.t0 is None:
                    self.t0 = now
                self._go.append(now - self.t0 < self.seconds_ns)
            return self._go[k]


@dataclass
class Slot:
    """The outputs of one step: (buffer, stamp row, output) for each op."""
    step: int = -1
    outs: List[Tuple[int, int, Optional[torch.Tensor]]] = field(
        default_factory=list)


@dataclass
class RankRecord:
    rank: int
    steps: List[Tuple[int, int]]            # (start, end) ns of each window step
    spans: List[Tuple[int, int, int]]       # (Caller code, start, end) ns
    kept: List[Slot]
    phases: Optional[dict]                  # name -> [(start, end, op key)]
    phase_lost: int                         # events the ring overwrote


@dataclass
class WorldSpec:
    mix: Mix
    seed: int
    seconds: float
    devices: List[object]                   # rank -> device (or LogicalDevice)
    sends: List[List[torch.Tensor]]         # rank -> send buffers
    stamps: List[traffic.Stamps]            # rank -> its stamps
    sync: Callable                          # sync(device) ends a step
    before_window: Callable = lambda: None  # main thread, ranks parked
    after_window: Callable = lambda: None
    phase_names: Tuple[str, ...] = ()


def _device_of(d):
    return getattr(d, "device", d)


def _read_phases(comm, names, window) -> Tuple[Optional[dict], int]:
    """The rank's phase spans inside the window, each with its op's key
    (communicator id, sequence number), and how many events the ring
    lost to wraparound (the sampled-out ops are not lost: they were
    never traced)."""
    tr = getattr(comm.state, "tracer", None)
    if tr is None:
        return None, 0
    lost = max(0, tr.cursor - tr.capacity)
    w0, w1 = window
    off = tr.anchor_ns - tr.anchor_wall * 1e9
    out = {n: [] for n in names}
    for e in tr.snapshot():
        if e["name"] in out and e.get("ph") == "X":
            s = int(e["ts"] * 1e9 + off)
            t = s + int(e["dur"] * 1e9)
            if s >= w0 and t <= w1:
                a = e.get("args") or {}
                out[e["name"]].append((s, t, (a.get("cid"), a.get("seq"))))
    return out, lost


def rank_program(spec: WorldSpec, gate: Gate, ready: threading.Barrier,
                 go: threading.Barrier, done: threading.Barrier):
    mix = spec.mix

    def fn(comm) -> RankRecord:
        r = comm.rank
        dev = _device_of(spec.devices[r])
        xs = spec.sends[r]
        stamps = spec.stamps[r]
        spans: list = []
        caller = Caller(mix, comm, spans)
        vector = mix.stride > 1
        nsets = 3 if vector else 1
        recv = [[traffic.recv_span(mix, comm.size, dev)
                 for _ in range(mix.ops_per_step)] for _ in range(nsets)] \
            if vector else None
        slots = [Slot(), Slot(), Slot()]   # latest; drawn (two for a vector)
        drawn = 2
        row = 0

        def step(k: int, slot: int) -> List[Tuple[int, int, object]]:
            nonlocal row
            outs = []
            for j in range(mix.ops_per_step):
                b = mix.buffer_of(k, j)
                stamps.apply(xs[b], row)
                y = caller.op(xs[b], recv[slot][j] if vector else None)
                outs.append((b, row, y))
                row += 1
            if mix.nonblocking:
                ys = caller.wait()
                outs = [(b, n, y) for (b, n, _), y in zip(outs, ys)]
            t0 = _now()
            spec.sync(dev)
            spans.append((Caller.SYNC, t0, _now()))
            return outs

        for k in range(mix.warm_steps):
            slots[0] = Slot()      # the last step's outputs are free
            slots[0] = Slot(k, step(k, 0))
        spec.sync(dev)
        comm.Barrier()
        del spans[:]
        ready.wait()
        go.wait()
        steps = []
        k = 0
        while gate.go(k):
            slot = 0
            if traffic.draw(spec.seed, k) < 1.0 / (k + 1):
                drawn = slot = (3 - drawn) if vector else 1
            slots[0] = Slot()      # the last step's outputs are free
            t0 = _now()
            outs = step(k, slot)
            steps.append((t0, _now()))
            slots[slot] = Slot(k, outs)
            outs = None
            if slot and vector:
                slots[3 - slot] = Slot()   # the older draw's spans are free
            k += 1
        done.wait()
        window = (steps[0][0], steps[-1][1]) if steps else (0, 0)
        phases, lost = _read_phases(comm, spec.phase_names, window)
        kept = [s for s in slots if s.step >= 0]
        return RankRecord(r, steps, spans, kept, phases, lost)

    return fn


def run_world(spec: WorldSpec, device_map, timeout: float):
    """Run the cell's world; returns the rank records."""
    from ompi_tpu_torch.testing import run_ranks
    n = len(spec.devices)
    gate = Gate(spec.seconds)
    ready = threading.Barrier(n + 1)
    go = threading.Barrier(n + 1)
    done = threading.Barrier(n + 1)
    box: dict = {}

    def world():
        try:
            box["records"] = run_ranks(
                n, rank_program(spec, gate, ready, go, done),
                device_map=device_map, timeout=timeout)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            box["error"] = e
            for b in (ready, go, done):
                b.abort()

    t = threading.Thread(target=world, name="portbench-world", daemon=True)
    t.start()
    try:
        ready.wait()
        spec.before_window()
        go.wait()
        done.wait()
        spec.after_window()
    except threading.BrokenBarrierError:
        pass
    t.join(timeout)
    if t.is_alive():
        raise TimeoutError(f"the world did not finish within {timeout} s")
    if "error" in box:
        raise box["error"]
    return box["records"]
