"""MPI_Info objects: ordered string key/value hints.

Port of the reference's info.py, a re-design of ompi/info (ref: ompi/info/info.c — ordered list with
key length limits; MPI_INFO_ENV prepopulated at init,
ref: ompi_mpi_init.c info_env setup).
"""

from __future__ import annotations

import os
import sys
from typing import Dict, List, Optional, Tuple

MAX_INFO_KEY = 255
MAX_INFO_VAL = 1024


class Info:
    def __init__(self) -> None:
        self._d: Dict[str, str] = {}

    # -- MPI surface ----------------------------------------------------
    def set(self, key: str, value: str) -> None:
        if not key or len(key) > MAX_INFO_KEY:
            raise ValueError(f"bad info key {key!r} (MPI_ERR_INFO_KEY)")
        if len(str(value)) > MAX_INFO_VAL:
            raise ValueError("info value too long (MPI_ERR_INFO_VALUE)")
        self._d[key] = str(value)

    def get(self, key: str) -> Tuple[bool, Optional[str]]:
        """(flag, value) like MPI_Info_get."""
        if key in self._d:
            return True, self._d[key]
        return False, None

    def delete(self, key: str) -> None:
        if key not in self._d:
            raise KeyError(f"no such info key {key} (MPI_ERR_INFO_NOKEY)")
        del self._d[key]

    def nkeys(self) -> int:
        return len(self._d)

    def nthkey(self, n: int) -> str:
        keys = list(self._d.keys())
        if not 0 <= n < len(keys):
            raise ValueError(f"info key index {n} out of range")
        return keys[n]

    def dup(self) -> "Info":
        out = Info()
        out._d = dict(self._d)
        return out

    def items(self):
        return self._d.items()

    def __repr__(self) -> str:
        return f"<Info {self._d!r}>"


INFO_NULL = None


def info_env(state=None) -> Info:
    """MPI_INFO_ENV: launch facts (ref: ompi_mpi_init.c's info_env)."""
    inf = Info()
    inf.set("command", sys.argv[0] if sys.argv else "")
    inf.set("argv", " ".join(sys.argv[1:]))
    if state is not None:
        inf.set("maxprocs", str(getattr(state.rte, "world_size",
                                        state.size)))
    inf.set("host", os.uname().nodename)
    inf.set("arch", os.uname().machine)
    inf.set("thread_level", "MPI_THREAD_MULTIPLE")
    return inf
