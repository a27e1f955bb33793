"""Loader for the native C++ data plane (ctypes; no pybind11).

Port of the reference's ``native.py``.  The sources are the checkout's
``native/*.cpp``, read and never written: the port compiles them with
the machine's C++ compiler into ``build/ompi_tpu_torch/native/`` at the
root of the checkout, one library named by a hash of the sources and
flags, built to a file named for the process and thread and moved into
place with ``os.replace`` (as ``kernels/build.py`` does), so that
processes building at once — and the reference's ``make -C native`` —
never race.  Every consumer has a pure-Python fallback: this is host
code, and a missing compiler only costs speed, never correctness.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_ROOT, "native")
BUILD_DIR = os.path.join(_ROOT, "build", "ompi_tpu_torch", "native")
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def compiler() -> Optional[str]:
    """$CXX, else c++ / g++ on PATH; None when there is none."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        if c and shutil.which(c):
            return shutil.which(c)
    return None


def lib_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256()
    for f in _sources():
        with open(f, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(CXXFLAGS).encode())
    return os.path.join(BUILD_DIR,
                        f"libtpumpi_native-{h.hexdigest()[:16]}.so")


def _sources():
    if not os.path.isdir(_NATIVE_DIR):
        return []
    return sorted(os.path.join(_NATIVE_DIR, f)
                  for f in os.listdir(_NATIVE_DIR) if f.endswith(".cpp"))


def _build(path: str) -> bool:
    cxx, srcs = compiler(), _sources()
    if cxx is None or not srcs:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run([cxx, *CXXFLAGS, "-o", tmp, *srcs],
                           capture_output=True, timeout=120)
        if r.returncode != 0:
            return False
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or none
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None (pure-Python fallback)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _sources():
            return None
        path = lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.tpumpi_ring_push.argtypes = [u8p, ctypes.c_uint64, u8p,
                                         ctypes.c_uint64]
        lib.tpumpi_ring_push.restype = ctypes.c_int
        lib.tpumpi_ring_push2.argtypes = [u8p, ctypes.c_uint64, u8p,
                                          ctypes.c_uint64, u8p,
                                          ctypes.c_uint64]
        lib.tpumpi_ring_push2.restype = ctypes.c_int
        lib.tpumpi_ring_peek.argtypes = [u8p, ctypes.c_uint64]
        lib.tpumpi_ring_peek.restype = ctypes.c_int64
        lib.tpumpi_ring_pop.argtypes = [u8p, ctypes.c_uint64, u8p,
                                        ctypes.c_uint64]
        lib.tpumpi_ring_pop.restype = ctypes.c_int
        lib.tpumpi_ring_readable.argtypes = [u8p]
        lib.tpumpi_ring_readable.restype = ctypes.c_uint64
        lib.tpumpi_pack_strided.argtypes = [u8p, u8p, ctypes.c_uint64,
                                            ctypes.c_int64, ctypes.c_uint64]
        lib.tpumpi_pack_strided.restype = None
        lib.tpumpi_unpack_strided.argtypes = [u8p, u8p, ctypes.c_uint64,
                                              ctypes.c_int64,
                                              ctypes.c_uint64]
        lib.tpumpi_unpack_strided.restype = None
        lib.tpumpi_seg_coll.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64]
        lib.tpumpi_seg_coll.restype = ctypes.c_int
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None
