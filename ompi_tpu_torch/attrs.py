"""Attribute keyvals with copy/delete callbacks.

Re-design of ompi/attribute (ref: ompi/attribute/attribute.c — one
keyval registry serving comms, wins and datatypes; copy callbacks run
on dup, delete callbacks on overwrite/delete/free).

A keyval is an integer handle bound to (copy_fn, delete_fn,
extra_state).  copy_fn(obj, keyval, extra_state, value) -> value or
None (None = don't propagate, the flag=0 case); delete_fn(obj,
keyval, value, extra_state).  Predefined world attributes (TAG_UB,
WTIME_IS_GLOBAL, UNIVERSE_SIZE) use negative handles.
"""

from __future__ import annotations

import itertools
import threading
from typing import Any, Callable, Dict, Optional, Tuple

# predefined keyval handles (ref: mpi.h MPI_TAG_UB et al.)
TAG_UB = -101
HOST = -102
IO = -103
WTIME_IS_GLOBAL = -104
UNIVERSE_SIZE = -106
APPNUM = -107
LASTUSEDCODE = -105

_registry: Dict[int, Tuple[Optional[Callable], Optional[Callable], Any]] = {}
_refs: Dict[int, int] = {}    # live attachments per keyval
_freed: set = set()           # freed-but-still-attached keyvals
_counter = itertools.count(1000)
_lock = threading.Lock()


def create_keyval(copy_fn: Optional[Callable] = None,
                  delete_fn: Optional[Callable] = None,
                  extra_state: Any = None) -> int:
    """MPI_{Comm,Win,Type}_create_keyval."""
    with _lock:
        kv = next(_counter)
        _registry[kv] = (copy_fn, delete_fn, extra_state)
    return kv


def free_keyval(keyval: int) -> None:
    """MPI_*_free_keyval: freeing is deferred while attributes are
    still attached — the (copy_fn, delete_fn, extra) entry stays live
    so later dup/free of holding objects still runs the callbacks
    (ref: ompi/attribute/attribute.c ompi_attr_free_keyval)."""
    with _lock:
        if keyval not in _registry:
            return
        if _refs.get(keyval, 0) > 0:
            _freed.add(keyval)
        else:
            _registry.pop(keyval, None)


def _ref(keyval: int, delta: int) -> None:
    if keyval < 0:
        return
    with _lock:
        n = _refs.get(keyval, 0) + delta
        if n <= 0:
            _refs.pop(keyval, None)
            if keyval in _freed:
                _freed.discard(keyval)
                _registry.pop(keyval, None)
        else:
            _refs[keyval] = n


def _entry(keyval: int):
    with _lock:
        e = _registry.get(keyval)
    if e is None and keyval >= 0:
        raise ValueError(f"invalid attribute keyval {keyval} "
                         "(MPI_ERR_KEYVAL)")
    return e or (None, None, None)


def set_attr(obj, keyval: int, value: Any) -> None:
    """Overwriting an existing value runs its delete callback first
    (ref: attribute.c set semantics).  Attaching through a freed
    keyval is erroneous (MPI_ERR_KEYVAL)."""
    _entry(keyval)
    with _lock:
        freed = keyval in _freed
    if freed:
        raise ValueError(f"attribute keyval {keyval} has been freed "
                         "(MPI_ERR_KEYVAL)")
    if keyval in obj.attrs:
        delete_attr(obj, keyval)
    obj.attrs[keyval] = value
    _ref(keyval, +1)


def get_attr(obj, keyval: int) -> Tuple[bool, Any]:
    """Returns (flag, value) like MPI_*_get_attr."""
    if keyval in obj.attrs:
        return True, obj.attrs[keyval]
    return False, None


def delete_attr(obj, keyval: int) -> None:
    copy_fn, delete_fn, extra = _entry(keyval)
    if keyval in obj.attrs:
        value = obj.attrs.pop(keyval)
        if delete_fn is not None:
            delete_fn(obj, keyval, value, extra)
        _ref(keyval, -1)


def copy_all(old, new) -> None:
    """Dup-time propagation: run each attribute's copy callback
    (ref: ompi_attr_copy_all)."""
    for keyval, value in list(old.attrs.items()):
        if keyval < 0:  # predefined attrs propagate as-is
            new.attrs[keyval] = value
            continue
        copy_fn, _d, extra = _entry(keyval)
        if copy_fn is None:
            continue  # MPI_NULL_COPY_FN: not propagated
        out = copy_fn(old, keyval, extra, value)
        if out is not None:
            new.attrs[keyval] = out
            _ref(keyval, +1)


def delete_all(obj) -> None:
    """Free-time teardown: run every delete callback
    (ref: ompi_attr_delete_all)."""
    for keyval in list(obj.attrs.keys()):
        if keyval < 0:
            obj.attrs.pop(keyval, None)
            continue
        delete_attr(obj, keyval)


def init_world_attrs(comm) -> None:
    """Predefined attributes on COMM_WORLD (ref: attribute.c
    ompi_attr_create_predefined)."""
    comm.attrs[TAG_UB] = 2**31 - 1
    comm.attrs[WTIME_IS_GLOBAL] = False
    comm.attrs[UNIVERSE_SIZE] = comm.state.size
    comm.attrs[APPNUM] = getattr(comm.state.rte, "appnum", 0)
