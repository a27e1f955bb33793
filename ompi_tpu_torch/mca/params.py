"""MCA-style variable registry: the single config plane.

TPU-native re-design of Open MPI's ``mca_base_var`` system
(ref: opal/mca/base/mca_base_var.c, mca_base_pvar.h:25-72,
mca_base_parse_paramfile.c).  Every tunable in the framework registers
here with type/scope/level metadata.  Precedence (lowest to highest):

    defaults < param files < environment (TPUMPI_MCA_*) < CLI/API overrides

Also hosts performance variables (pvars): monotonically increasing
counters / watermarks for the MPI_T tool layer (tools.info and
mpit).
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

ENV_PREFIX = "TPUMPI_MCA_"
PARAM_FILE_ENV = "TPUMPI_PARAM_FILES"
DEFAULT_PARAM_FILES = (
    os.path.expanduser("~/.tpu_mpi/tpumpi-mca-params.conf"),
    "tpumpi-mca-params.conf",
)

# Variable info levels, mirroring MPI_T verbosity classes
# (ref: opal/mca/base/mca_base_var.h enum mca_base_var_info_lvl_t).
LEVEL_USER_BASIC = 1
LEVEL_USER_DETAIL = 2
LEVEL_USER_ALL = 3
LEVEL_TUNER_BASIC = 4
LEVEL_TUNER_DETAIL = 5
LEVEL_TUNER_ALL = 6
LEVEL_DEV_BASIC = 7
LEVEL_DEV_DETAIL = 8
LEVEL_DEV_ALL = 9

# Value sources, highest-precedence wins
# (ref: opal/mca/base/mca_base_var.h mca_base_var_source_t).
SOURCE_DEFAULT = 0
SOURCE_FILE = 1
SOURCE_ENV = 2
SOURCE_OVERRIDE = 3  # CLI --mca or programmatic set


def _coerce(value: Any, typ: type) -> Any:
    if typ is bool:
        if isinstance(value, str):
            return value.strip().lower() in ("1", "true", "yes", "on", "enabled")
        return bool(value)
    if typ is int and isinstance(value, str):
        v = value.strip().lower()
        mult = 1
        for suf, m in (("k", 1 << 10), ("m", 1 << 20), ("g", 1 << 30)):
            if v.endswith(suf):
                v, mult = v[:-1], m
                break
        return int(float(v) * mult)
    return typ(value)


@dataclass
class Var:
    """One registered control variable."""

    framework: str
    component: str
    name: str
    default: Any
    typ: type
    help: str = ""
    level: int = LEVEL_USER_BASIC
    read_only: bool = False
    value: Any = None
    source: int = SOURCE_DEFAULT

    @property
    def full_name(self) -> str:
        parts = [p for p in (self.framework, self.component, self.name) if p]
        return "_".join(parts)


@dataclass
class PVar:
    """Performance variable: counter/level/watermark bound to a getter.

    Ref: opal/mca/base/mca_base_pvar.h:25-72; consumed by the MPI_T
    analog in ompi_tpu_torch.mpit.
    """

    framework: str
    component: str
    name: str
    help: str = ""
    var_class: str = "counter"  # counter | level | highwatermark | size
    getter: Optional[Callable[[], Any]] = None
    _value: Any = 0

    @property
    def full_name(self) -> str:
        parts = [p for p in (self.framework, self.component, self.name) if p]
        return "_".join(parts)

    def read(self) -> Any:
        if self.getter is not None:
            return self.getter()
        return self._value

    def add(self, n: Any = 1) -> None:
        self._value += n

    def update_max(self, n: Any) -> None:
        if n > self._value:
            self._value = n


class VarRegistry:
    """Process-wide registry of control + performance variables."""

    def __init__(self) -> None:
        self._vars: Dict[str, Var] = {}
        self._pvars: Dict[str, PVar] = {}
        self._overrides: Dict[str, Any] = {}
        self._file_values: Optional[Dict[str, str]] = None
        self._lock = threading.RLock()

    # -- control variables ------------------------------------------------
    def register(
        self,
        framework: str,
        component: str,
        name: str,
        default: Any,
        typ: Optional[type] = None,
        help: str = "",
        level: int = LEVEL_USER_BASIC,
        read_only: bool = False,
    ) -> Var:
        typ = typ or (type(default) if default is not None else str)
        var = Var(framework, component, name, default, typ, help, level, read_only)
        with self._lock:
            existing = self._vars.get(var.full_name)
            if existing is not None:
                return existing
            self._vars[var.full_name] = var
            var.value, var.source = self._resolve(var)
        return var

    def _load_files(self) -> Dict[str, str]:
        if self._file_values is not None:
            return self._file_values
        values: Dict[str, str] = {}
        paths: List[str] = list(DEFAULT_PARAM_FILES)
        extra = os.environ.get(PARAM_FILE_ENV)
        if extra:
            paths += extra.split(":")
        for path in paths:
            try:
                with open(path) as fh:
                    for line in fh:
                        line = line.strip()
                        if not line or line.startswith("#"):
                            continue
                        if "=" in line:
                            k, _, v = line.partition("=")
                            values[k.strip()] = v.strip()
            except OSError:
                continue
        self._file_values = values
        return values

    def _resolve(self, var: Var):
        full = var.full_name
        if full in self._overrides:
            return _coerce(self._overrides[full], var.typ), SOURCE_OVERRIDE
        env = os.environ.get(ENV_PREFIX + full)
        if env is None:
            # schizo analog (ref: orte/mca/schizo/ompi — per-frontend
            # env translation): accept the reference's OMPI_MCA_*
            # spelling so users migrating from Open MPI keep their
            # environment verbatim; our prefix wins when both are set
            env = os.environ.get("OMPI_MCA_" + full)
        if env is not None:
            return _coerce(env, var.typ), SOURCE_ENV
        fv = self._load_files().get(full)
        if fv is not None:
            return _coerce(fv, var.typ), SOURCE_FILE
        if var.default is None:
            return None, SOURCE_DEFAULT
        return _coerce(var.default, var.typ), SOURCE_DEFAULT

    def set(self, full_name: str, value: Any) -> None:
        """Highest-precedence override (CLI --mca or programmatic)."""
        with self._lock:
            self._overrides[full_name] = value
            var = self._vars.get(full_name)
            if var is not None:
                var.value, var.source = _coerce(value, var.typ), SOURCE_OVERRIDE

    def get(self, full_name: str, default: Any = None) -> Any:
        var = self._vars.get(full_name)
        if var is None:
            return default
        return var.value

    def lookup(
        self, framework: str, component: str, name: str, default: Any = None
    ) -> Any:
        parts = [p for p in (framework, component, name) if p]
        return self.get("_".join(parts), default)

    def all_vars(self) -> List[Var]:
        return sorted(self._vars.values(), key=lambda v: v.full_name)

    def vars_in_registration_order(self) -> List[Var]:
        """Stable enumeration for MPI_T: indices never shift because
        later registrations only append (dict preserves insertion)."""
        return list(self._vars.values())

    def pvars_in_registration_order(self) -> List[PVar]:
        return list(self._pvars.values())

    def refresh(self) -> None:
        """Re-resolve every variable (e.g. after env changes in tests)."""
        with self._lock:
            self._file_values = None
            for var in self._vars.values():
                var.value, var.source = self._resolve(var)

    # -- performance variables -------------------------------------------
    def register_pvar(
        self,
        framework: str,
        component: str,
        name: str,
        help: str = "",
        var_class: str = "counter",
        getter: Optional[Callable[[], Any]] = None,
    ) -> PVar:
        pvar = PVar(framework, component, name, help, var_class, getter)
        with self._lock:
            existing = self._pvars.get(pvar.full_name)
            if existing is not None:
                return existing
            self._pvars[pvar.full_name] = pvar
        return pvar

    def all_pvars(self) -> List[PVar]:
        return sorted(self._pvars.values(), key=lambda p: p.full_name)


# The process-wide registry instance (like the static state in
# mca_base_var.c).  Fresh MPI worlds in the same process share it.
registry = VarRegistry()


def parse_mca_args(argv: List[str]) -> List[str]:
    """Consume ``--mca key value`` pairs from argv, applying overrides.

    Returns the remaining argv.  Mirrors mpirun's MCA CLI handling
    (ref: orte/mca/schizo/ompi personality CLI translation).
    """
    out: List[str] = []
    i = 0
    while i < len(argv):
        if argv[i] == "--mca" and i + 2 < len(argv) + 1:
            registry.set(argv[i + 1], argv[i + 2])
            i += 3
        else:
            out.append(argv[i])
            i += 1
    return out
