"""Verbosity-stream logging + keyed user diagnostics.

Re-design of opal_output (ref: opal/util/output.c) and show_help
(ref: opal/util/show_help.c).  Streams carry a per-framework verbosity
level controlled through the variable registry
(``<framework>_base_verbose``); show_help renders keyed, de-duplicated
user-facing diagnostics the way the reference's HNP aggregates them.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Dict, Optional, Set, TextIO

from ompi_tpu_torch.mca.params import registry

_lock = threading.Lock()
_seen_help: Set[str] = set()


class OutputStream:
    def __init__(self, tag: str, verbose_key: Optional[str] = None,
                 file: Optional[TextIO] = None) -> None:
        self.tag = tag
        self.verbose_key = verbose_key or f"{tag}_base_verbose"
        self.file = file or sys.stderr

    @property
    def level(self) -> int:
        return int(registry.get(self.verbose_key, 0) or 0)

    def verbose(self, level: int, msg: str, *args) -> None:
        if self.level >= level:
            self.output(msg, *args)

    def output(self, msg: str, *args) -> None:
        if args:
            msg = msg % args
        rank = os.environ.get("TPUMPI_RANK", "?")
        with _lock:
            self.file.write(f"[{self.tag}:{rank}] {msg}\n")
            self.file.flush()


_streams: Dict[str, OutputStream] = {}


def get_stream(tag: str) -> OutputStream:
    st = _streams.get(tag)
    if st is None:
        st = OutputStream(tag)
        _streams[tag] = st
    return st


def verbose(tag: str, level: int, msg: str, *args) -> None:
    get_stream(tag).verbose(level, msg, *args)


# Keyed help topics: the analog of the reference's help-text ini files
# (opal/util/show_help.c keyed *.txt files).  Kept inline as a dict —
# a Python package has no install-tree to scan.
_HELP_TOPICS: Dict[str, str] = {
    "no-component": (
        "No usable component was found for framework '%(framework)s'.\n"
        "Check your --mca %(framework)s selection."),
    "abort": (
        "Rank %(rank)s aborted the job (error code %(code)s) in "
        "communicator %(comm)s."),
    "truncate": (
        "A message was truncated: posted receive of %(recv)s bytes, "
        "incoming message of %(send)s bytes."),
    "launch-failed": (
        "Failed to launch process %(rank)s: %(reason)s"),
    "proc-died": (
        "Process %(rank)s (pid %(pid)s) terminated unexpectedly with "
        "status %(status)s; aborting the remaining processes."),
}


def show_help(topic: str, dedup: bool = True, **fields) -> None:
    """Render a keyed diagnostic once (de-duplicated per process)."""
    key = topic + repr(sorted(fields.items()))
    with _lock:
        if dedup and key in _seen_help:
            return
        _seen_help.add(key)
    text = _HELP_TOPICS.get(topic, topic)
    try:
        text = text % fields
    except (KeyError, ValueError):
        pass
    bar = "-" * 70
    sys.stderr.write(f"{bar}\n{text}\n{bar}\n")
    sys.stderr.flush()
