"""The comparison that decides ``correct`` must fail what is wrong.

On the CPU, at a size a test run holds (the cell's element counts cut by
``SCALE``, the program's plain kernel versions): a sound run of every
cell is correct; the control (the reference one precision down, in the
program's place) fails its limits; and a whole run with the timed path
broken underneath reads ``correct`` false, once for each fault a
collective can have.
"""

import json
import os
import time

import pytest
import torch

from portbench import check, harness, spec, traffic
from portbench.spec import ROOT

SCALE = 512
SECONDS = 0.3


def _cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return [w["name"] for w in json.load(fh)["workloads"]]


def _temp_cell(tmp_path, mix, config="colo8", config_doc=None,
               limits='{"max_err": 0.0003, "bad": 0}'):
    """A cell ``<config>.t`` of mix ``mix`` added as data in a temp copy
    of the benchmark, as a later cell would bring it: a traffic file, a
    limits file, an entry, and the configuration's file if it is new."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    base = tmp_path / "portbench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (base / d).mkdir(parents=True)
    if config_doc is None:
        with open(os.path.join(ROOT, "portbench", "configs",
                               f"{config}.json")) as fh:
            config_doc = json.load(fh)
    else:
        bench["configs"].append({"name": config, "source": "x", "reduced": [],
                                 "file": f"portbench/configs/{config}.json",
                                 "why": "x"})
    (base / "configs" / f"{config}.json").write_text(json.dumps(config_doc))
    bench["workloads"].append({"name": f"{config}.t", "config": config,
                               "traffic": "t", "chips": 1, "why": "x"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    for m in os.listdir(os.path.join(ROOT, "portbench", "metrics")):
        if m.endswith(".py"):
            with open(os.path.join(ROOT, "portbench", "metrics", m)) as fh:
                (base / "metrics" / m).write_text(fh.read())
    (base / "traffic" / "t.json").write_text(json.dumps(mix))
    (base / "limits" / f"{config}.t.json").write_text(limits)
    return spec.resolve(f"{config}.t", root=str(tmp_path), base=str(base))


def _run(cell, seed=2**32 + 17):
    run, info, numbers, nkept = harness.execute(
        cell, seed, SECONDS, False, True, SCALE, time.perf_counter())
    return run, numbers, nkept


@pytest.mark.parametrize("cell_name", _cells())
def test_a_sound_run_is_correct(cell_name):
    cell = spec.resolve(cell_name)
    run, numbers, nkept = _run(cell)
    assert check.verdict(numbers, cell.limits), numbers
    n = cell.config["ranks"]
    ops = cell.traffic["ops_per_step"]
    assert run.ops == len(run.steps_ns) * ops
    # the latest step and the drawn one (the same step when only one ran)
    assert nkept in (n * ops, 2 * n * ops)


@pytest.mark.parametrize("cell_name", _cells())
def test_the_control_fails(cell_name):
    cell = spec.resolve(cell_name)
    mix = traffic.Mix.from_dict(cell.traffic_name, cell.traffic, SCALE)
    n = cell.config["ranks"]
    devs = ["cpu"] * n
    for seed in (11, 12, 2**33 + 1):
        sends = [traffic.make_inputs(mix, seed, r, "cpu") for r in range(n)]
        stamps = [traffic.Stamps(mix, seed, r, "cpu") for r in range(n)]
        kept = check.control_kept(mix, sends, stamps, range(n), [0], devs,
                                  row=seed % 7)
        numbers = check.compare(mix, sends, stamps, kept)
        assert numbers["bad"] == 0
        assert not check.verdict(numbers, cell.limits), numbers


def _own_block(comm, x):
    m = x.numel() // comm.size
    return x[comm.rank * m:(comm.rank + 1) * m].clone()


def _half(orig, ident):
    """The reduction over the first half of the ranks, the rest left out
    (a sum scaled back up, as a mean over the half that came)."""
    def f(comm, x, op):
        keep = comm.rank < comm.size // 2
        y = orig(comm, x if keep else torch.full_like(x, ident), op)
        return y * 2 if ident == 0.0 else y
    return f


def _faults(kind):
    from ompi_tpu_torch.comm.communicator import Communicator
    name = {"allreduce": "allreduce_arr",
            "reduce_scatter": "reduce_scatter_arr"}[kind]
    orig = getattr(Communicator, name)
    ident = 0.0 if kind == "allreduce" else -torch.inf

    def unchanged(comm, x, op):
        # the step hands back its input: no reduction at all
        return x.clone() if kind == "allreduce" else _own_block(comm, x)

    def no_exchange(comm, x, op):
        # each rank reduces what it holds, the peers' parts left out
        if kind == "allreduce":
            return x * comm.size
        return _own_block(comm, x)

    first = {}

    def stale(comm, x, op):
        # the answer of the buffer's first op, served again at every
        # later op on it (a result kept from an earlier step)
        key = (comm.rank, x.data_ptr())
        if key not in first:
            first[key] = orig(comm, x, op)
        return first[key].clone()

    def altered(comm, x, op):
        # one element of one rank's answer: 1e-3 off a float32 sum (far
        # past rounding), one unit in the last place off an exact max
        y = orig(comm, x, op)
        if comm.rank == comm.size - 1:
            y = y.clone()
            i = y.numel() // 3
            y[i] = y[i] + 1e-3 if kind == "allreduce" else torch.nextafter(
                y[i], torch.tensor(torch.inf, dtype=y.dtype))
        return y

    return name, {"unchanged": unchanged, "half": _half(orig, ident),
                  "no_exchange": no_exchange, "stale": stale,
                  "altered": altered}


@pytest.mark.parametrize("cell_name", _cells())
@pytest.mark.parametrize("fault", ["unchanged", "half", "no_exchange",
                                   "stale", "altered"])
def test_a_broken_timed_path_is_not_correct(cell_name, fault, monkeypatch):
    from ompi_tpu_torch.comm.communicator import Communicator
    cell = spec.resolve(cell_name)
    name, faults = _faults(cell.traffic["op"])
    monkeypatch.setattr(Communicator, name, faults[fault])
    run, numbers, nkept = _run(cell, seed=900 + len(fault))
    assert not check.verdict(numbers, cell.limits), numbers


RSVEC = {"op": "reduce_scatter", "reduce": "max", "dtype": "float64",
         "elements": 1 << 16, "stride": 2, "buffers": 4, "ops_per_step": 4}


def test_a_vector_mix_is_correct_and_a_skipped_unpack_is_not(monkeypatch,
                                                              tmp_path):
    """BASELINE config 5's shape (device_pack, reduce_scatter MAX of
    float64, device_unpack into a stride-2 span), added as data."""
    cell = _temp_cell(tmp_path, RSVEC, limits='{"max_err": 0, "bad": 0}')
    run, numbers, nkept = _run(cell)
    assert check.verdict(numbers, cell.limits), numbers
    from ompi_tpu_torch.datatype import device as ddev
    monkeypatch.setattr(ddev, "device_unpack", lambda dt, c, p, out: out)
    run, numbers, nkept = _run(cell)
    assert not check.verdict(numbers, cell.limits), numbers


def test_a_four_card_configuration_takes_the_mesh_tier(tmp_path):
    mix = {"op": "allreduce", "reduce": "sum", "dtype": "float32",
           "elements": 1 << 16, "buffers": 4, "ops_per_step": 4}
    cell = _temp_cell(tmp_path, mix, config="mesh4",
                      config_doc={"name": "mesh4", "ranks": 4, "cards": 4})
    run, numbers, nkept = _run(cell, seed=2**31 + 3)
    assert check.verdict(numbers, cell.limits), numbers
    assert run.route["coll_tpu_offloaded_collectives"] == 4   # every op


MIXES = {
    "bcast": {"op": "bcast", "dtype": "float32", "root": 3},
    "alltoall": {"op": "alltoall", "dtype": "float32"},
    "allgather": {"op": "allgather", "dtype": "float64", "stride": 2},
    "iallreduce": {"op": "allreduce", "reduce": "sum", "dtype": "float32",
                   "nonblocking": True},
    "reduce_scatter-min": {"op": "reduce_scatter", "reduce": "min",
                           "dtype": "float32"},
}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_mix_added_as_data_runs_and_is_judged(tmp_path, mix, monkeypatch):
    """The generator's other ops, as a later cell would bring them: a
    traffic file, a limits file and an entry, no code."""
    cell = _temp_cell(tmp_path, dict(MIXES[mix], elements=8 * 1024,
                                     buffers=3, ops_per_step=3))
    run, info, numbers, nkept = harness.execute(
        cell, 77, SECONDS, False, True, 1, time.perf_counter())
    assert check.verdict(numbers, cell.limits), numbers
    assert run.ops == 3 * len(run.steps_ns) and nkept >= 8 * 3
    # and a rank that hands back its input is caught
    from ompi_tpu_torch.comm.communicator import Communicator
    name = {"bcast": "bcast_arr", "alltoall": "alltoall_arr",
            "allgather": "allgather_arr", "iallreduce": "iallreduce_arr",
            "reduce_scatter-min": "reduce_scatter_arr"}[mix]
    orig = getattr(Communicator, name)

    def broken(comm, x, *a):
        y = orig(comm, x, *a)
        if comm.rank == 1 and isinstance(y, torch.Tensor):
            y = y.clone()
            y[0] += 0.5
        elif comm.rank == 1:
            q, first = y, y.wait

            def wait(*w):
                first(*w)
                q.result = q.result.clone()
                q.result[0] += 0.5
            q.wait = wait
        return y
    monkeypatch.setattr(Communicator, name, broken)
    run, info, numbers, nkept = harness.execute(
        cell, 78, SECONDS, False, True, 1, time.perf_counter())
    assert not check.verdict(numbers, cell.limits), numbers
