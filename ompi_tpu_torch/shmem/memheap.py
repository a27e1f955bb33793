"""memheap: the symmetric-heap allocator framework.

Port of the reference's shmem/memheap.py, a re-design of
oshmem/mca/memheap (ref: memheap_buddy.c — power-of-two
buddy allocator over the symmetric segment; memheap_ptmalloc as the
general-purpose alternative).  Components register with the MCA
framework and are selected per context by ``shmem_memheap_allocator``;
both are DETERMINISTIC: shmem_malloc is collective and symmetry
requires every PE to compute the same offset from the same call
sequence.

State is capturable (checkpoint/restart snapshots the allocator
alongside the heap bytes).

The allocator is storage-agnostic: it deals in OFFSETS only, so the
same component serves a host heap (numpy segment behind the pt2pt
window) and a device heap (a shard on the card behind osc/device,
where the offsets feed ``Window.put/get`` displacements and
``read_local`` spans instead of pointer math)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from ompi_tpu_torch.mca.base import Component, frameworks
from ompi_tpu_torch.mca.params import registry

memheap_framework = frameworks.create("shmem", "memheap")

_alloc_var = registry.register(
    "shmem", "memheap", "allocator", "buddy", str,
    help="Symmetric-heap allocator component: 'buddy' (power-of-two "
         "blocks, O(log n) malloc/free, bounded fragmentation — the "
         "memheap/buddy analog) or 'firstfit' (hole list, tight "
         "packing for long-lived regular allocations)")

_ALIGN = 64
_MIN_ORDER = 6  # 64-byte blocks


class Allocator:
    """Deterministic offset allocator over ``size`` heap bytes."""

    name = "base"

    def __init__(self, size: int) -> None:
        self.size = size

    def malloc(self, nbytes: int) -> int:
        raise NotImplementedError

    def free(self, offset: int) -> None:
        raise NotImplementedError

    def state(self) -> tuple:
        raise NotImplementedError

    def restore(self, state: tuple) -> None:
        raise NotImplementedError


class FirstFit(Allocator):
    """Hole-list first fit with coalescing (the ptmalloc-role
    component: tight packing, no internal fragmentation beyond
    alignment)."""

    name = "firstfit"

    def __init__(self, size: int) -> None:
        super().__init__(size)
        self._holes: List[Tuple[int, int]] = [(0, size)]
        self._live: Dict[int, int] = {}

    def malloc(self, nbytes: int) -> int:
        # zero-size allocations still get a distinct slot, else they
        # alias the next malloc and free() releases live memory
        want = max((nbytes + _ALIGN - 1) // _ALIGN * _ALIGN, _ALIGN)
        for i, (off, size) in enumerate(self._holes):
            if size >= want:
                self._holes[i] = (off + want, size - want)
                if self._holes[i][1] == 0:
                    del self._holes[i]
                self._live[off] = want
                return off
        raise MemoryError(nbytes)

    def free(self, offset: int) -> None:
        size = self._live.pop(offset, None)
        if size is None:
            return
        self._holes.append((offset, size))
        self._holes.sort()
        merged: List[Tuple[int, int]] = []
        for off, sz in self._holes:
            if merged and merged[-1][0] + merged[-1][1] == off:
                merged[-1] = (merged[-1][0], merged[-1][1] + sz)
            else:
                merged.append((off, sz))
        self._holes = merged

    def state(self) -> tuple:
        return ("firstfit", list(self._holes), dict(self._live))

    def restore(self, state: tuple) -> None:
        _, holes, live = state
        self._holes = [tuple(h) for h in holes]
        self._live = {int(k): int(v) for k, v in live.items()}


class Buddy(Allocator):
    """Power-of-two buddy system (ref: memheap_buddy.c): the heap is
    covered by maximal power-of-two top blocks; malloc splits the
    smallest free block of sufficient order down to the fit, free
    coalesces with the buddy (offset XOR size) as far as it goes.
    Free blocks per order are kept sorted and the LOWEST offset wins,
    so the allocation pattern is identical on every PE."""

    name = "buddy"

    def __init__(self, size: int) -> None:
        super().__init__(size)
        self._free: Dict[int, List[int]] = {}   # order -> sorted offsets
        self._live: Dict[int, int] = {}         # offset -> order
        self._tops: set = set()                 # (offset, order) roots
        off = 0
        while size - off >= (1 << _MIN_ORDER):
            order = (size - off).bit_length() - 1
            # a top block must be naturally aligned for buddy math
            while off & ((1 << order) - 1):
                order -= 1
            self._free.setdefault(order, []).append(off)
            self._tops.add((off, order))
            off += 1 << order

    def malloc(self, nbytes: int) -> int:
        want = max(nbytes, 1)
        order = max(_MIN_ORDER, (want - 1).bit_length())
        o = order
        while o not in self._free or not self._free[o]:
            o += 1
            if o > 64:
                raise MemoryError(nbytes)
        off = self._free[o].pop(0)
        while o > order:   # split down, keep the low half
            o -= 1
            lst = self._free.setdefault(o, [])
            lst.append(off + (1 << o))
            lst.sort()
        self._live[off] = order
        return off

    def free(self, offset: int) -> None:
        order = self._live.pop(offset, None)
        if order is None:
            return
        while (offset, order) not in self._tops:
            buddy = offset ^ (1 << order)
            lst = self._free.get(order, [])
            if buddy in lst:
                lst.remove(buddy)
                offset = min(offset, buddy)
                order += 1
            else:
                break
        lst = self._free.setdefault(order, [])
        lst.append(offset)
        lst.sort()

    def state(self) -> tuple:
        return ("buddy",
                {k: list(v) for k, v in self._free.items()},
                dict(self._live))

    def restore(self, state: tuple) -> None:
        _, free, live = state
        self._free = {int(k): sorted(v) for k, v in free.items()}
        self._live = {int(k): int(v) for k, v in live.items()}


class _MemheapComponent(Component):
    def __init__(self, name: str, cls, priority: int) -> None:
        super().__init__()
        self.name = name
        self._cls = cls
        self.priority = priority

    def query(self, size=None):
        return (self.priority, self._cls)


memheap_framework.add_component(_MemheapComponent("buddy", Buddy, 50))
memheap_framework.add_component(
    _MemheapComponent("firstfit", FirstFit, 40))


def select(size: int) -> Allocator:
    """The MCA-selected allocator for a ``size``-byte heap."""
    name = _alloc_var.value
    for comp in memheap_framework.components():
        if comp.name == name:
            return comp.query()[1](size)
    raise ValueError(
        f"unknown shmem_memheap_allocator {name!r} "
        "(components: buddy, firstfit)")


def restore(state: tuple, size: int) -> Allocator:
    """Rebuild the allocator a snapshot carried (its own component,
    regardless of the current MCA selection)."""
    cls = {"firstfit": FirstFit, "buddy": Buddy}[state[0]]
    alloc = cls(size)
    alloc.restore(state)
    return alloc
