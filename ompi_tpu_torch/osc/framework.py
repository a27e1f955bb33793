"""osc framework: per-window component selection (``osc_select``).

Mirrors the coll framework's device reroute at window granularity
(ref: ompi/mca/osc/base/osc_base_init.c ompi_osc_base_select — every
component is queried per window and the highest priority wins):

    device   priority 40   the window COMMITS TO THE MESH — either
                           Win_create over a tensor or Win_allocate
                           minting one — and the comm's ranks own
                           distinct devices (``comm.mesh()``)
    pt2pt    priority 10   always usable (host AM over the pml)

``--mca osc <list>`` (``registry.set("osc", "pt2pt")``) restricts the
candidates exactly like ``--mca coll``.  The verdict is cached per
comm under ``comm.__dict__["_osc_pick"]``.

A tensor is device-committed memory (a numpy array is host memory); in
the CPU tests a CPU tensor plays the part of a card tensor.  The pt2pt
component takes a CPU tensor in place and refuses a card tensor: it
never stages a card's memory through the host (the reference snapshots
a device buffer to the host there).
"""

from __future__ import annotations

import torch

from ompi_tpu_torch.mca.base import Component, frameworks
from ompi_tpu_torch.mca.params import registry

osc_framework = frameworks.create("ompi", "osc")


def _is_device_committed(memory) -> bool:
    """True when the window memory is a tensor (the Win_create-over-
    device-memory case)."""
    return isinstance(memory, torch.Tensor)


class Pt2ptComponent(Component):
    name = "pt2pt"
    priority = 10

    def register_params(self, framework) -> None:
        self._pri_var = registry.register(
            "osc", "pt2pt", "priority", 10, int,
            help="Selection priority of the host AM osc component")

    def query(self, comm, memory, mint):  # noqa: ARG002
        return (self._pri_var.value, self)

    def build(self, comm, memory, disp_unit, name, info, mint):
        from ompi_tpu_torch.osc import window as _w
        if mint:
            return _w.allocate(comm, memory, disp_unit or 1, name)
        return _w.create(comm, memory, disp_unit, name, info=info)


class DeviceComponent(Component):
    name = "device"
    priority = 40

    def register_params(self, framework) -> None:
        self._pri_var = registry.register(
            "osc", "device", "priority", 40, int,
            help="Selection priority of the device-memory osc "
                 "component (wins when the window commits to the "
                 "comm's mesh)")

    def query(self, comm, memory, mint):
        if comm.mesh() is None:
            return None
        if not mint and not _is_device_committed(memory):
            return None
        return (self._pri_var.value, self)

    def build(self, comm, memory, disp_unit, name, info, mint):
        from ompi_tpu_torch.osc import device as _d
        if mint:
            return _d.allocate(comm, memory, disp_unit or 1, name)
        return _d.create(comm, memory, disp_unit, name, info=info)


osc_framework.add_component(Pt2ptComponent())
osc_framework.add_component(DeviceComponent())


def osc_select(comm, memory=None, mint: bool = False) -> Component:
    """The per-window component decision, cached per (mint, committed)
    shape on the comm."""
    pick = comm.__dict__.get("_osc_pick")
    if pick is None:
        pick = {}
        comm.__dict__["_osc_pick"] = pick
    key = (bool(mint), _is_device_committed(memory))
    comp = pick.get(key)
    if comp is None:
        comp, _payload = osc_framework.select_one(comm, memory, mint)
        pick[key] = comp
    return comp


def win_create(comm, memory, disp_unit=None, name: str = "",
               info=None):
    comp = osc_select(comm, memory, mint=False)
    return comp.build(comm, memory, disp_unit, name, info, mint=False)


def win_allocate(comm, nbytes: int, disp_unit: int = 1,
                 name: str = ""):
    comp = osc_select(comm, None, mint=True)
    return comp.build(comm, nbytes, disp_unit, name, None, mint=True)
