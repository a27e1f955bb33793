"""Memchecker-analog: buffer-access validity checking for MPI usage
errors.

Re-design of opal/mca/memchecker/valgrind (ref:
memchecker_valgrind_module.c:28-29 — annotate send/recv buffers
noaccess/defined around request lifecycles so Valgrind flags user
code touching in-flight buffers).  Python cannot mark pages, so the
same two error classes are caught differently:

  * **recv-buffer read-before-complete**: a posted receive buffer is
    POISONED (0xCB) at post time; user code consuming stale bytes
    sees loud garbage instead of silently stale data, and the poison
    pattern makes it grep-able.
  * **send-buffer modification while in flight**: a checksum of the
    send buffer is recorded at isend and verified at completion —
    a mismatch raises, naming the request (the MPI-2 erroneous
    program the reference's memchecker flags).

Enable with ``--mca opal_memchecker_enable 1`` (off by default: poisoning
costs a memset per receive, checksums a pass per send — same
price/benefit as running the reference under Valgrind).
"""

from __future__ import annotations

import zlib
from typing import Optional

import numpy as np

from ompi_tpu_torch.mca.params import registry

_enabled_var = registry.register(
    "opal", "memchecker", "enable", False, bool,
    help="Poison posted recv buffers and checksum in-flight send "
         "buffers to catch MPI buffer-usage errors (memchecker "
         "analog)")

POISON = 0xCB


def enabled() -> bool:
    return _enabled_var.value


def poison_recv(conv) -> None:
    """Fill the receive region with the poison pattern at post time
    (the VALGRIND_MAKE_MEM_NOACCESS analog)."""
    view = getattr(conv, "_view", None)
    if view is not None:  # ContigConvertor fast path
        view[:] = POISON


def send_checksum(conv) -> Optional[int]:
    """Checksum the send region at activation (cheap crc32; the
    VALGRIND_CHECK_MEM_IS_DEFINED analog)."""
    view = getattr(conv, "_view", None)
    if view is None:
        return None
    return zlib.crc32(memoryview(np.ascontiguousarray(view)))


def verify_send(conv, crc: Optional[int], req_desc: str) -> None:
    """At completion, a changed send buffer is an MPI usage error
    (the program modified a buffer owned by an active request)."""
    if crc is None:
        return
    now = send_checksum(conv)
    if now is not None and now != crc:
        raise RuntimeError(
            f"memchecker: send buffer of {req_desc} was modified "
            f"while the request was in flight (MPI forbids touching "
            f"a buffer owned by an active request)")
