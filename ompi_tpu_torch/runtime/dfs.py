"""dfs: read-only access to files on OTHER hosts of the job.

Re-design of orte/mca/dfs (ref: dfs.h:50-107 and dfs/app/dfs_app.c —
an app opens ``file://host/path``, and open/seek/read are forwarded
to the daemon on the host that owns the file; read-only by design).
The collapse here: requests ride the existing KV control plane
— a rank's node-local KV proxy serves files on its OWN node
directly, and forwards other hosts upstream, where the HNP serves
its host's files.  The primary dfs use case — compute ranks reading
input staged on the launch host without a shared filesystem — is
exactly that one forwarded hop.

    from ompi_tpu_torch.runtime import dfs
    f = dfs.open("file://hnp//data/input.bin", comm.state.rte)
    header = f.read(128)
    f.seek(0)
    ...
    f.close()

Local paths (no host, or this host's name) bypass the control plane
entirely and use posix."""

from __future__ import annotations

import os
from typing import Optional

from ompi_tpu_torch.runtime.kvstore import dfs_parse_uri

SEEK_SET, SEEK_CUR, SEEK_END = 0, 1, 2


class DfsFile:
    """One open (possibly remote) read-only file."""

    def __init__(self, uri: str, rte=None) -> None:
        host, path = dfs_parse_uri(uri)
        me = os.environ.get("TPUMPI_NODE_NAME", "")
        self._pos = 0
        self._closed = False
        if host in ("", "localhost") or host == me:
            self._kv = None
            self._fd = os.open(path, os.O_RDONLY)
            self._size = os.fstat(self._fd).st_size
        else:
            kv = getattr(rte, "kv", None)
            if kv is None:
                raise OSError(
                    f"dfs: no control plane to reach host {host!r} "
                    "(not launched under mpirun?)")
            self._kv = kv
            self._fd, self._size = kv.dfs_open(uri)

    # -- surface (dfs.h contract: open/size/seek/read/close) ------------
    def size(self) -> int:
        return self._size

    def seek(self, offset: int, whence: int = SEEK_SET) -> int:
        new = {SEEK_SET: offset,
               SEEK_CUR: self._pos + offset,
               SEEK_END: self._size + offset}[whence]
        if new < 0 or new > self._size:
            # the reference errors on seeking past EOF (contrary to
            # lseek, consistent with read-only files: dfs.h:86-89)
            raise OSError(f"dfs seek to {new} outside [0, {self._size}]")
        self._pos = new
        return new

    def tell(self) -> int:
        return self._pos

    def pread(self, offset: int, n: int) -> bytes:
        if self._kv is None:
            return os.pread(self._fd, n, offset)
        return self._kv.dfs_read(self._fd, offset, n)

    def read(self, n: Optional[int] = None) -> bytes:
        if n is None:
            n = self._size - self._pos
        data = self.pread(self._pos, n)
        self._pos += len(data)
        return data

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._kv is None:
            os.close(self._fd)
        else:
            self._kv.dfs_close(self._fd)

    def __enter__(self) -> "DfsFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open(uri: str, rte=None) -> DfsFile:  # noqa: A001 (dfs.open API)
    return DfsFile(uri, rte)
