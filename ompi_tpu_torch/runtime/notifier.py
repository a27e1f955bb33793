"""Admin event sinks — the orte/mca/notifier analog.

Re-design of orte/mca/notifier (ref: orte/mca/notifier/syslog,
orte/mca/notifier/smtp — administrator-facing job events routed to
pluggable sinks, selected by MCA parameter).  Sinks here:

  * ``stderr`` (default) — one-line tagged records;
  * ``syslog``           — stdlib syslog (severity-mapped);
  * ``file:<path>``      — append-only event log.

The launcher's errmgr state handlers call ``notify`` on job-level
events (proc failure, daemon loss, abort, timeout); severities follow
the reference's ORTE_NOTIFIER_{EMERG..DEBUG} ladder.
"""

from __future__ import annotations

import sys
import time
from typing import List

from ompi_tpu_torch.mca.params import registry

_sinks_var = registry.register(
    "orte", "notifier", "sinks", "", str,
    help="Comma list of admin event sinks: stderr, syslog, "
         "file:<path>.  Empty (default) = off — mpirun's own stderr "
         "diagnostics always print regardless.")

SEVERITIES = ("emerg", "alert", "crit", "error", "warn", "notice",
              "info", "debug")


def _emit_stderr(severity: str, job: str, msg: str) -> None:
    sys.stderr.write(
        f"[notifier:{severity}] {time.strftime('%H:%M:%S')} "
        f"job={job} {msg}\n")
    sys.stderr.flush()


def _emit_syslog(severity: str, job: str, msg: str) -> None:
    import syslog
    level = {
        "emerg": syslog.LOG_EMERG, "alert": syslog.LOG_ALERT,
        "crit": syslog.LOG_CRIT, "error": syslog.LOG_ERR,
        "warn": syslog.LOG_WARNING, "notice": syslog.LOG_NOTICE,
        "info": syslog.LOG_INFO, "debug": syslog.LOG_DEBUG,
    }.get(severity, syslog.LOG_NOTICE)
    syslog.syslog(level, f"ompi_tpu_torch job={job}: {msg}")


def _emit_file(path: str, severity: str, job: str, msg: str) -> None:
    with open(path, "a") as fh:
        fh.write(f"{time.time():.3f} {severity} job={job} {msg}\n")


_warned_sinks: set = set()


def notify(severity: str, job: str, msg: str) -> None:
    """Route one admin event to every configured sink.  EMIT-time
    failures are swallowed (losing a notification must never take the
    job down — the reference's notifier discipline), but a
    misconfigured sink NAME warns once: a typo silently disabling
    admin events is undetectable otherwise."""
    if severity not in SEVERITIES:
        severity = "notice"
    for sink in [s.strip() for s in _sinks_var.value.split(",") if s]:
        try:
            if sink == "stderr":
                _emit_stderr(severity, job, msg)
            elif sink == "syslog":
                _emit_syslog(severity, job, msg)
            elif sink.startswith("file:"):
                _emit_file(sink[5:], severity, job, msg)
            elif sink not in _warned_sinks:
                _warned_sinks.add(sink)
                sys.stderr.write(
                    f"[notifier] unknown sink {sink!r} in "
                    f"orte_notifier_sinks (expected stderr, syslog, "
                    f"file:<path>)\n")
        except Exception:  # noqa: BLE001 — see docstring
            pass
