"""One-sided RMA (MPI-3 windows).

Two components behind a real osc framework decision (framework.py):
``pt2pt`` — host AM over the pml (window.py) — and ``device`` —
windows backed by one shard a rank on the comm's devices (device.py).
``create``/``allocate`` route through ``osc_select``; the host-only
entry points (dynamic/shared windows) stay pt2pt."""

from .window import (LOCK_EXCLUSIVE, LOCK_SHARED, Window,
                     allocate_shared, create_dynamic, shared_query)
from .framework import osc_framework, osc_select


def create(comm, memory, disp_unit=None, name: str = "", info=None):
    """MPI_Win_create through component selection: a tensor on a
    comm whose ranks own distinct devices gets the device window."""
    return _fw.win_create(comm, memory, disp_unit, name, info)


def allocate(comm, nbytes: int, disp_unit: int = 1, name: str = ""):
    """MPI_Win_allocate through component selection: mints a shard on
    each rank's device when the comm has a mesh."""
    return _fw.win_allocate(comm, nbytes, disp_unit, name)


from ompi_tpu_torch.osc import framework as _fw  # noqa: E402

__all__ = ["Window", "create", "allocate", "create_dynamic",
           "allocate_shared", "shared_query", "osc_framework",
           "osc_select", "LOCK_SHARED", "LOCK_EXCLUSIVE"]
