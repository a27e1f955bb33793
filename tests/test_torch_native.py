"""The port's native C++ data plane (ompi_tpu_torch/native.py, built
from the checkout's native/*.cpp into build/ompi_tpu_torch/native/):
shm ring atomics, strided pack, Python<->native interop — the analog
of tests/test_native.py — and the build itself: wherever a C++
compiler is present the library is built and loaded, and the sources'
directory is never written."""

import ctypes
import os
import threading

import numpy as np
import pytest

from ompi_tpu_torch import native



@pytest.fixture(autouse=True)
def _built(request):
    """The ring cases need the library; the build case decides itself
    (decided in the test, never at import)."""
    if request.node.name != "test_built_and_loaded_where_a_compiler_is" \
            and not native.available():
        pytest.skip("no C++ compiler: the pure-Python ring is used")


def test_built_and_loaded_where_a_compiler_is():
    if native.compiler() is None:
        pytest.skip("no C++ compiler on this machine")
    before = sorted(os.listdir(native._NATIVE_DIR))
    lib = native.load()
    assert lib is not None, "a compiler is present but the ring did not build"
    path = native.lib_path()
    assert os.path.dirname(path) == native.BUILD_DIR
    assert os.path.exists(path)
    assert sorted(os.listdir(native._NATIVE_DIR)) == before
    from ompi_tpu_torch.btl.shm import Ring
    assert Ring.__init__  # the shm ring loads the same library
    assert native.load() is lib


def _mk_ring(tmp_path, cap=1 << 16):
    from ompi_tpu_torch.mca.params import registry
    registry.set("btl_shm_ring_size", cap)
    from ompi_tpu_torch.btl.shm import Ring
    registry.refresh()
    r = Ring(str(tmp_path / "ring.buf"), create=True)
    registry.set("btl_shm_ring_size", 8 * 1024 * 1024)
    return r


def test_ring_roundtrip(tmp_path):
    r = _mk_ring(tmp_path)
    assert r._lib is not None
    frames = [b"hello", b"", b"x" * 1000, os.urandom(4096)]
    for f in frames:
        assert r.push(f)
    for f in frames:
        assert r.pop() == f
    assert r.pop() is None


def test_ring_wraparound(tmp_path):
    r = _mk_ring(tmp_path, cap=1 << 12)
    payload = os.urandom(1000)
    for _ in range(50):  # force wrap many times
        assert r.push(payload)
        assert r.pop() == payload


def test_ring_backpressure(tmp_path):
    r = _mk_ring(tmp_path, cap=1 << 12)
    big = b"y" * 3000
    assert r.push(big)
    assert not r.push(big)  # full
    assert r.pop() == big
    assert r.push(big)      # space released


def test_ring_python_native_interop(tmp_path):
    """Native producer, Python consumer and vice versa."""
    r = _mk_ring(tmp_path)
    lib_saved = r._lib
    msg = os.urandom(513)
    # native push, python pop
    assert r.push_native(msg)
    r._lib = None
    assert r.pop() == msg
    # python push, native pop
    assert r.push(msg + b"2")
    r._lib = lib_saved
    assert r.pop_native() == msg + b"2"


def test_ring_threaded_stress(tmp_path):
    """SPSC stress across threads (cross-process covered by the
    launcher integration tests)."""
    r = _mk_ring(tmp_path, cap=1 << 14)
    N = 2000
    out = []

    def producer():
        i = 0
        while i < N:
            if r.push(i.to_bytes(4, "big") + bytes([i % 251] * (i % 97))):
                i += 1

    def consumer():
        while len(out) < N:
            f = r.pop()
            if f is not None:
                out.append(f)

    tp = threading.Thread(target=producer)
    tc = threading.Thread(target=consumer)
    tp.start(); tc.start()
    tp.join(30); tc.join(30)
    assert len(out) == N
    for i, f in enumerate(out):
        assert int.from_bytes(f[:4], "big") == i
        assert f[4:] == bytes([i % 251] * (i % 97))


def test_pack_strided_matches_numpy():
    lib = native.load()
    src = np.arange(1000, dtype=np.uint8)
    dst = np.zeros(300, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tpumpi_pack_strided(
        src.ctypes.data_as(u8p), dst.ctypes.data_as(u8p), 30, 100, 10)
    exp = np.concatenate([src[i * 100:i * 100 + 30] for i in range(10)])
    np.testing.assert_array_equal(dst, exp)
    back = np.zeros(1000, dtype=np.uint8)
    lib.tpumpi_unpack_strided(
        back.ctypes.data_as(u8p), dst.ctypes.data_as(u8p), 30, 100, 10)
    ref = np.zeros(1000, dtype=np.uint8)
    for i in range(10):
        ref[i * 100:i * 100 + 30] = src[i * 100:i * 100 + 30]
    np.testing.assert_array_equal(back, ref)
