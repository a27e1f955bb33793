"""MPI_T tool-information interface over the variable registry.

Re-design of ompi/mpi/tool (ref: ompi/mpi/tool/mpit-internal.h; the
MPI_T chapter's object model: control variables = the MCA var
registry, performance variables = the pvar registry, categories =
frameworks).  Usable before/after MPI init, like MPI_T itself — the
registry is process-global.

    import ompi_tpu_torch.mpit as mpit
    mpit.init_thread()
    n = mpit.cvar_get_num()
    h = mpit.cvar_handle_alloc("coll_tuned_use_device")
    mpit.cvar_write(h, 0)
    s = mpit.pvar_session_create()
    ph = mpit.pvar_handle_alloc(s, "pml_monitoring_messages_size")
    mpit.pvar_read(ph)
"""

from __future__ import annotations

import copy
import threading
from typing import Any, Dict, List, Optional

from ompi_tpu_torch.mca.params import (PVar, Var, registry, SOURCE_DEFAULT,
                                 SOURCE_ENV, SOURCE_FILE, SOURCE_OVERRIDE)

ERR_INVALID_INDEX = "MPI_T_ERR_INVALID_INDEX"
ERR_INVALID_NAME = "MPI_T_ERR_INVALID_NAME"
ERR_NOT_INITIALIZED = "MPI_T_ERR_NOT_INITIALIZED"

SCOPE_READONLY = "readonly"
SCOPE_ALL = "all"

_lock = threading.Lock()
_init_count = 0


class MpitError(RuntimeError):
    def __init__(self, code: str, msg: str = "") -> None:
        super().__init__(f"{code}: {msg}" if msg else code)
        self.code = code


def init_thread() -> None:
    """MPI_T_init_thread: reference-counted (mpit-internal.h model)."""
    global _init_count
    with _lock:
        _init_count += 1


def finalize() -> None:
    global _init_count
    with _lock:
        if _init_count == 0:
            raise MpitError(ERR_NOT_INITIALIZED)
        _init_count -= 1


def _check_init() -> None:
    if _init_count == 0:
        raise MpitError(ERR_NOT_INITIALIZED, "call mpit.init_thread() first")


# -- control variables ------------------------------------------------------

def cvar_get_num() -> int:
    _check_init()
    return len(registry.vars_in_registration_order())


def _cvar_at(index: int) -> Var:
    # registration order: MPI_T indices must never change once
    # returned, and new registrations only append in this order
    vars_ = registry.vars_in_registration_order()
    if not 0 <= index < len(vars_):
        raise MpitError(ERR_INVALID_INDEX, str(index))
    return vars_[index]


def cvar_get_info(index: int) -> Dict[str, Any]:
    """Name/help/type/level/scope of the index-th variable
    (registration-order enumeration — stable across new
    registrations, as MPI_T requires of indices)."""
    _check_init()
    v = _cvar_at(index)
    return {
        "name": v.full_name,
        "help": v.help,
        "type": v.typ.__name__,
        "level": v.level,
        "scope": SCOPE_READONLY if v.read_only else SCOPE_ALL,
        "default": v.default,
    }


def cvar_get_index(name: str) -> int:
    _check_init()
    for i, v in enumerate(registry.vars_in_registration_order()):
        if v.full_name == name:
            return i
    raise MpitError(ERR_INVALID_NAME, name)


class CvarHandle:
    def __init__(self, var: Var) -> None:
        self.var = var


def cvar_handle_alloc(name_or_index) -> CvarHandle:
    _check_init()
    if isinstance(name_or_index, str):
        return CvarHandle(_cvar_at(cvar_get_index(name_or_index)))
    return CvarHandle(_cvar_at(name_or_index))


def cvar_read(handle: CvarHandle) -> Any:
    _check_init()
    return handle.var.value


def cvar_write(handle: CvarHandle, value: Any) -> None:
    _check_init()
    if handle.var.read_only:
        raise MpitError("MPI_T_ERR_CVAR_SET_NEVER", handle.var.full_name)
    registry.set(handle.var.full_name, value)


# -- performance variables --------------------------------------------------

class PvarSession:
    """MPI_T_pvar_session: isolates handle start/stop/reset baselines
    so concurrent tools don't clobber each other."""

    def __init__(self) -> None:
        self.handles: List["PvarHandle"] = []


class PvarHandle:
    def __init__(self, session: PvarSession, pvar: PVar) -> None:
        self.session = session
        self.pvar = pvar
        self.started = True    # continuous pvars start started
        self._baseline = None  # raw reads until the first reset
        self._frozen = None    # value snapshot while stopped


def pvar_get_num() -> int:
    _check_init()
    return len(registry.pvars_in_registration_order())


def pvar_get_info(index: int) -> Dict[str, Any]:
    _check_init()
    pvars = registry.pvars_in_registration_order()
    if not 0 <= index < len(pvars):
        raise MpitError(ERR_INVALID_INDEX, str(index))
    p = pvars[index]
    return {"name": p.full_name, "help": p.help, "class": p.var_class}


def pvar_get_index(name: str) -> int:
    _check_init()
    for i, p in enumerate(registry.pvars_in_registration_order()):
        if p.full_name == name:
            return i
    raise MpitError(ERR_INVALID_NAME, name)


def pvar_session_create() -> PvarSession:
    _check_init()
    return PvarSession()


def pvar_session_free(session: PvarSession) -> None:
    _check_init()
    session.handles.clear()


def pvar_handle_alloc(session: PvarSession, name_or_index) -> PvarHandle:
    _check_init()
    pvars = registry.pvars_in_registration_order()
    if isinstance(name_or_index, str):
        idx = pvar_get_index(name_or_index)
    else:
        idx = name_or_index
        if not 0 <= idx < len(pvars):
            raise MpitError(ERR_INVALID_INDEX, str(idx))
    h = PvarHandle(session, pvars[idx])
    session.handles.append(h)
    return h


def pvar_start(handle: PvarHandle) -> None:
    _check_init()
    handle.started = True
    handle._frozen = None


def pvar_stop(handle: PvarHandle) -> None:
    """Freeze the handle: reads return the value at stop time."""
    _check_init()
    handle._frozen = copy.deepcopy(handle.pvar.read())
    handle.started = False


def pvar_read(handle: PvarHandle) -> Any:
    """Value relative to the handle's last reset (lists element-wise);
    frozen at the stop-time snapshot while the handle is stopped."""
    _check_init()
    val = handle.pvar.read() if handle.started else handle._frozen
    base = handle._baseline
    if base is None:
        return val
    if isinstance(val, list):
        if isinstance(base, list) and len(base) == len(val):
            return [a - b for a, b in zip(val, base)]
        return list(val)
    if isinstance(val, (int, float)) and isinstance(base, (int, float)):
        return val - base
    return val


def pvar_reset(handle: PvarHandle) -> None:
    _check_init()
    val = handle.pvar.read()
    handle._baseline = copy.deepcopy(val) if isinstance(val, list) else val


# -- categories (frameworks as the category tree) ---------------------------

def category_get_num() -> int:
    _check_init()
    from ompi_tpu_torch.mca.base import frameworks
    return len(frameworks.all())


def category_get_info(index: int) -> Dict[str, Any]:
    _check_init()
    from ompi_tpu_torch.mca.base import frameworks
    fws = frameworks.all()
    if not 0 <= index < len(fws):
        raise MpitError(ERR_INVALID_INDEX, str(index))
    fw = fws[index]
    prefix = fw.name + "_"
    cvars = [i for i, v in enumerate(registry.vars_in_registration_order())
             if v.full_name.startswith(prefix) or v.full_name == fw.name]
    pvars = [i for i, p in enumerate(registry.pvars_in_registration_order())
             if p.full_name.startswith(prefix)]
    return {"name": fw.name, "project": fw.project,
            "num_cvars": len(cvars), "cvar_indices": cvars,
            "num_pvars": len(pvars), "pvar_indices": pvars}


# -- whole-registry snapshot (telemetry plane) ------------------------------

def pvar_snapshot(prefix: Optional[str] = None) -> Dict[str, Any]:
    """Every pvar's current value keyed by full name, in registration
    order.  A tool-facing convenience for the obs scrape path (the DVM
    ``metrics`` RPC and the tpud OOB op): read-only against the
    process-global registry, so — like MPI_T itself — it needs no
    init_thread and never perturbs handle baselines.  Getter errors
    surface as None rather than aborting the scrape.  ``prefix``
    filters by full-name prefix (e.g. ``"dvm_"`` or ``"ctrl_"``) so a
    fleet scraper polling one subsystem does not pay for — or ship —
    the whole registry every tick."""
    out: Dict[str, Any] = {}
    for p in registry.pvars_in_registration_order():
        if prefix is not None and not p.full_name.startswith(prefix):
            continue
        try:
            out[p.full_name] = p.read()
        except Exception:
            out[p.full_name] = None
    return out
