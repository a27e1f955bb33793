"""File views: mapping (disp, etype, filetype) to file byte segments.

Port of the reference's io/view.py, a re-design of ompio's view
machinery (ref: ompi/mca/io/ompio/
io_ompio_file_set_view.c + the segment decoding in
io_ompio.c:ompi_io_ompio_decode_datatype — the filetype is flattened
once into an (offset, length) iovec per tile; tiles repeat every
``extent`` bytes in the file; only bytes inside segments are visible
through the view).

The flattening reuses the datatype engine's Run descriptors
(ompi_tpu_torch.datatype.engine) instead of a separate decoder.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import List, Tuple

from ompi_tpu_torch.datatype import engine as dtmod


def _flatten(datatype) -> List[Tuple[int, int]]:
    """Merged, sorted (offset, nbytes) segments of one filetype tile."""
    segs: List[Tuple[int, int]] = []
    for r in datatype.runs:
        for b in range(r.nblocks):
            segs.append((r.disp + b * r.stride, r.block_bytes))
    segs.sort()
    merged: List[Tuple[int, int]] = []
    for off, ln in segs:
        if merged and merged[-1][0] + merged[-1][1] == off:
            merged[-1] = (merged[-1][0], merged[-1][1] + ln)
        else:
            merged.append((off, ln))
    return merged


class FileView:
    """disp + repeating filetype tiles; positions are in etype units
    (the MPI file-pointer unit)."""

    def __init__(self, disp: int = 0, etype=None, filetype=None) -> None:
        self.disp = disp
        self.etype = etype if etype is not None else dtmod.BYTE
        self.filetype = filetype if filetype is not None else self.etype
        if self.filetype.size % self.etype.size:
            raise ValueError("filetype size must be a multiple of etype "
                             "size (MPI_ERR_ARG)")
        self.segs = _flatten(self.filetype)
        self.tile_bytes = sum(ln for _, ln in self.segs)  # data per tile
        # the filetype's extent IS the tile stride — a resized type may
        # legally have extent < true_ub as long as consecutive tiles'
        # data segments interleave without overlapping
        self.tile_extent = self.filetype.extent
        if self.tile_bytes != self.filetype.size:
            raise ValueError("overlapping filetype segments")
        self._check_tile_overlap()
        # prefix sums of segment data bytes for O(log n) seek
        self._prefix = [0]
        for _, ln in self.segs:
            self._prefix.append(self._prefix[-1] + ln)

    def _check_tile_overlap(self) -> None:
        """Tiles repeat every ``extent`` bytes, so byte b of tile k
        lands at b + k*extent: two tiles collide iff two data bytes of
        one tile are congruent mod extent.  Fold every segment into
        [0, extent) and require the folded intervals to be disjoint —
        this accepts legal interleavings (e.g. data [0,4)+[12,16) with
        extent 8) and rejects genuine overlaps (MPI_ERR_TYPE)."""
        if not self.segs:
            return
        e = self.tile_extent
        if e <= 0 or self.tile_bytes > e:
            raise ValueError(
                f"filetype tiles overlap: {self.tile_bytes} data bytes "
                f"per tile exceed the {e}-byte tile extent (MPI_ERR_TYPE)")
        folded: List[Tuple[int, int]] = []
        for off, ln in self.segs:
            off %= e
            while ln > 0:
                take = min(ln, e - off)
                folded.append((off, take))
                ln -= take
                off = 0
        folded.sort()
        for (o1, l1), (o2, _) in zip(folded, folded[1:]):
            if o1 + l1 > o2:
                raise ValueError(
                    "filetype tiles overlap: data bytes at offsets "
                    f"{o2} and {o1}+{l1} collide mod the {e}-byte "
                    "extent (MPI_ERR_TYPE)")

    def is_contiguous(self) -> bool:
        return (len(self.segs) == 1
                and self.tile_extent == self.tile_bytes)

    def map_bytes(self, pos_etypes: int, nbytes: int
                  ) -> List[Tuple[int, int]]:
        """Absolute file (offset, nbytes) segments for `nbytes` of data
        starting at file pointer `pos_etypes` (etype units)."""
        if nbytes == 0 or self.tile_bytes == 0:
            return []
        start = pos_etypes * self.etype.size  # data-space byte position
        if self.is_contiguous():
            return [(self.disp + self.segs[0][0]
                     + (start // self.tile_bytes) * self.tile_extent
                     + start % self.tile_bytes, nbytes)] \
                if self.tile_bytes else []
        out: List[Tuple[int, int]] = []
        tile, within = divmod(start, self.tile_bytes)
        # locate the segment containing `within`
        i = bisect_right(self._prefix, within) - 1
        remaining = nbytes
        while remaining > 0:
            if i >= len(self.segs):
                tile += 1
                i = 0
                within = 0
            seg_off, seg_len = self.segs[i]
            skip = within - self._prefix[i]
            take = min(seg_len - skip, remaining)
            abs_off = self.disp + tile * self.tile_extent + seg_off + skip
            if out and out[-1][0] + out[-1][1] == abs_off:
                out[-1] = (out[-1][0], out[-1][1] + take)
            else:
                out.append((abs_off, take))
            remaining -= take
            i += 1
            within = self._prefix[i] if i < len(self.segs) else 0
        return out
