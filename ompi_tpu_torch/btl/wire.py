"""Binary wire codec for pml frags: header + raw payload, no pickle.

Re-design of the reference's frag wire format (ref:
opal/mca/btl/tcp/btl_tcp_frag.c — headers and convertor-packed bytes
go on the wire, never serialized objects; header layout ref:
ompi/mca/pml/ob1/pml_ob1_hdr.h).  The six ob1 frag kinds each get a
fixed little-endian struct header; the payload buffer is appended raw
so transports can scatter/gather it (``sendmsg``) or copy it into a
ring without an intermediate serialization copy.  Anything that is
not a recognized ob1 frag (future frameworks, tests) falls back to
pickle under code 0 — correctness never depends on the fast path.

Frame layout (after the transport's own 4-byte length prefix):

    [0]     code: 0=pickle, 1=MATCH, 2=MATCH_SYNC, 3=RNDV, 4=ACK,
                  5=SYNC_ACK, 6=FRAG
    [1:N)   fixed signed-64 fields per kind (struct below)
    [N:)    raw payload bytes (kinds 1,2,3,6)
"""

from __future__ import annotations

import pickle
import struct
from typing import Any, Optional, Tuple

# field structs (code byte included so encode is one pack call)
_M = struct.Struct("<Bqqqqq")        # MATCH: cid src tag seq gsrc
_MS = struct.Struct("<Bqqqqqq")      # MATCH_SYNC: ... sreq_id
_R = struct.Struct("<Bqqqqqqq")      # RNDV: ... total sreq_id
_A = struct.Struct("<Bqq")           # ACK: sreq_id rreq_id
_SA = struct.Struct("<Bq")           # SYNC_ACK: sreq_id
_F = struct.Struct("<Bqq")           # FRAG: rreq_id pos

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

# ---------------------------------------------------------------------
# header integrity (btl/tcp reliable sublayer)
# ---------------------------------------------------------------------
# A flipped bit in a header field silently mis-matches a message (wrong
# cid/tag/seq) — far worse than a payload flip, which at least lands in
# the right buffer.  The reliable tcp layer CRCs the header span of
# every frame; a mismatch is NACKed and the frame retransmitted.  The
# span covers the full fixed struct per kind; pickle/unknown frames are
# covered over min(64, len) bytes — enough to protect the dispatch
# code byte and the object header without rescanning megabyte payloads.

_HDR_SIZES = {1: _M.size, 2: _MS.size, 3: _R.size, 4: _A.size,
              5: _SA.size, 6: _F.size}


class CorruptFrame(ValueError):
    """Header CRC mismatch: the frame must not reach the pml."""


def hdr_span(frame) -> int:
    """Bytes of ``frame`` covered by the header CRC."""
    n = _HDR_SIZES.get(frame[0])
    if n is None or n > len(frame):
        return min(64, len(frame))
    return n


def frame_crc(frame) -> int:
    import zlib
    return zlib.crc32(bytes(frame[:hdr_span(frame)])) & 0xFFFFFFFF


def check_crc(frame, crc: int) -> None:
    if frame_crc(frame) != crc:
        raise CorruptFrame(
            f"wire header CRC mismatch (code byte {frame[0]})")


def payload_crc(hdr, payload=None) -> int:
    """CRC of everything the header CRC does NOT cover: the hdr tail
    past the span (pickle bodies) plus the raw payload buffer.  The
    sender computes it from (hdr, payload) before they are gathered;
    the receiver recomputes from the contiguous frame — identical
    bytes, identical digest (btl_tcp_payload_digest)."""
    import zlib
    c = zlib.crc32(bytes(hdr[hdr_span(hdr):]))
    if payload is not None:
        if not isinstance(payload, (bytes, bytearray, memoryview)):
            payload = memoryview(payload)
        c = zlib.crc32(payload, c)
    return c & 0xFFFFFFFF


def check_payload_crc(frame, crc: int) -> None:
    if payload_crc(frame) != crc:
        raise CorruptFrame(
            f"wire payload CRC mismatch (code byte {frame[0]})")


def _is_buf(x) -> bool:
    """Only real byte buffers ride the binary fast path; opaque
    payload objects (device arrays, btl/tpu) take the pickle
    fallback, which host-stages them via __getstate__."""
    return isinstance(x, (bytes, bytearray, memoryview))


def _fits(*vals: int) -> bool:
    for v in vals:
        if not (isinstance(v, int) and _I64_MIN <= v <= _I64_MAX):
            return False
    return True


def encode(frag: Any) -> Tuple[bytes, Optional[Any]]:
    """Return ``(header, payload)``.  ``header`` is small bytes;
    ``payload`` is the frag's buffer (bytes/memoryview) to be placed
    on the wire immediately after, or None."""
    if type(frag) is tuple and frag:
        k = frag[0]
        if k == "M" and len(frag) == 7 and _is_buf(frag[6]) \
                and _fits(*frag[1:6]):
            return _M.pack(1, *frag[1:6]), frag[6]
        if k == "F" and len(frag) == 4 and _is_buf(frag[3]) \
                and _fits(*frag[1:3]):
            return _F.pack(6, *frag[1:3]), frag[3]
        if k == "A" and len(frag) == 3 and _fits(*frag[1:]):
            return _A.pack(4, *frag[1:]), None
        if k == "SA" and len(frag) == 2 and _fits(frag[1]):
            return _SA.pack(5, frag[1]), None
        if k == "MS" and len(frag) == 8 and _is_buf(frag[7]) \
                and _fits(*frag[1:7]):
            return _MS.pack(2, *frag[1:7]), frag[7]
        if k == "R" and len(frag) == 9 and _is_buf(frag[8]) \
                and _fits(*frag[1:8]):
            return _R.pack(3, *frag[1:8]), frag[8]
    return b"\x00" + pickle.dumps(frag, protocol=pickle.HIGHEST_PROTOCOL), None


def decode(frame, copy: bool = True) -> Any:
    """Decode one full frame (bytes/memoryview, no length prefix).
    With ``copy=True`` payload slices are copied to bytes so callers
    may recycle the backing buffer; ``copy=False`` hands out zero-copy
    slices of an immutable frame."""
    code = frame[0]
    if copy:
        pl = bytes
    else:
        if isinstance(frame, bytes):
            frame = memoryview(frame)
        pl = lambda b: b  # noqa: E731 — slices below are zero-copy views
    if code == 1:
        _, cid, src, tag, seq, gsrc = _M.unpack_from(frame)
        return ("M", cid, src, tag, seq, gsrc, pl(frame[_M.size:]))
    if code == 6:
        _, rreq_id, pos = _F.unpack_from(frame)
        return ("F", rreq_id, pos, pl(frame[_F.size:]))
    if code == 4:
        _, sreq_id, rreq_id = _A.unpack_from(frame)
        return ("A", sreq_id, rreq_id)
    if code == 5:
        return ("SA", _SA.unpack_from(frame)[1])
    if code == 2:
        _, cid, src, tag, seq, gsrc, sreq_id = _MS.unpack_from(frame)
        return ("MS", cid, src, tag, seq, gsrc, sreq_id,
                pl(frame[_MS.size:]))
    if code == 3:
        _, cid, src, tag, seq, gsrc, total, sreq_id = _R.unpack_from(frame)
        return ("R", cid, src, tag, seq, gsrc, total, sreq_id,
                pl(frame[_R.size:]))
    if code == 0:
        return pickle.loads(bytes(frame[1:]))
    raise ValueError(f"bad wire code {code}")
