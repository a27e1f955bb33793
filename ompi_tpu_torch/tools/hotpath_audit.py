"""hotpath_audit: AST lint holding the trace hot path to its budget.

The port's copy of the reference's ``ompi_tpu/tools/hotpath_audit.py``.

The always-on tracing budget (DESIGN.md §9) is enforced structurally:
the functions that run once per message / per collective may not
allocate container objects, build strings, or read the wall clock.
Reviewing that by eye does not survive refactors, so tier-1 tests run
this audit and fail when a hot function regresses.

Banned inside a declared hot function:

  * tuple / list displays in Load context (allocation per call) —
    Store-context targets (``a, b = req.tr``) are unpacking, not
    allocation, and stay legal
  * dict / set displays and every comprehension flavor
  * f-strings and string concatenation via ``%`` / ``.format`` calls
  * calls to the ``dict`` / ``list`` / ``set`` / ``tuple`` /
    ``frozenset`` builtins
  * any reference to ``time.time`` (including sneaking it in via a
    default argument) — hot timestamps are ``perf_counter_ns`` only

Usage: ``python -m ompi_tpu_torch.tools.hotpath_audit`` exits nonzero and
prints one line per violation; ``audit()`` returns them as a list for
the tier-1 test.
"""

from __future__ import annotations

import ast
import sys
from typing import Dict, List, Tuple

# (module path relative to the package root, {qualified function: ...})
# Qualified names are "Class.method" or bare "function".  The port's
# copy declares the reference's hot functions under the port's paths.
HOT_FUNCTIONS: Dict[str, Tuple[str, ...]] = {
    "ompi_tpu_torch/trace/__init__.py": (
        "Tracer.start",
        "Tracer.start_sampled",
        "Tracer.end",
        "Tracer.point",
        "Tracer._put",
        "Tracer.device_pair",
        "Tracer.tick_ns",
        "Tracer.hist_add",
        "Tracer.req_mark",
        "coll_begin",
        "coll_end",
    ),
    "ompi_tpu_torch/pml/ob1.py": (
        "PmlOb1._trace_p2p_end",
    ),
    # phase-profiler record points: they run once per rendezvous wait
    # / segment / dispatched op whenever trace_phase_enable is on, so
    # they obey the same no-allocation rules as the tracer itself —
    # the ph context tuple is built ONCE per op at the gate, never
    # inside these.  The meeting's record points (cat meet) run on every
    # traced op: Rendezvous.begin / finish / _work and _fence call
    # these and record nothing themselves
    "ompi_tpu_torch/coll/device.py": (
        "_ph_rdv_start",
        "_ph_rdv_end",
        "_phase_fn",
        "_meet_wait_end",
        "_meet_lock",
        "_meet_post",
        "_marked_body",
        "_meet_device",
    ),
    # the launch marks of a traced meeting's body (coll/device.py
    # _marked_body), on every launch of the port's kernels
    "ompi_tpu_torch/kernels/stacked.py": (
        "arm_marks",
        "launch_stream",
    ),
    "ompi_tpu_torch/coll/pipeline.py": (
        "_pull_segment",
    ),
    # the plan executor runs once per large-message collective in
    # steady state: span shell, the single rendezvous, integer pvar
    # adds; packing and plan resolution live in helpers off this path
    "ompi_tpu_torch/coll/plan.py": (
        "Plan.execute",
    ),
    # the progress sweep runs on every blocking wait iteration
    "ompi_tpu_torch/runtime/progress.py": (
        "Progress.progress",
    ),
    # device-osc data-plane entries: the trace/pvar shells around
    # every one-sided op — a sampled span start, the impl call, and
    # integer pvar adds
    "ompi_tpu_torch/osc/device.py": (
        "DeviceWindow.put",
        "DeviceWindow.get",
        "DeviceWindow._acc_entry",
    ),
    # the integrity plane touches every device collective when armed:
    # sample() is the 1-in-N countdown gate on the meet path (the
    # reference's ``fold`` has no counterpart: the port folds claims
    # in ``_fold_claims`` on the checked path only)
    "ompi_tpu_torch/obs/integrity.py": (
        "sample",
    ),
    # the telemetry scrape rides 1 in 256 progress sweeps on a traced
    # rank whenever obs_scrape_interval_ms > 0: no clock read of its
    # own, a round-robin single-histogram integer copy only when the
    # interval elapses, never an allocation
    "ompi_tpu_torch/obs/__init__.py": (
        "Scraper.tick",
    ),
    # the checkpoint engine's drain tick rides every low-priority
    # progress sweep once a filesystem epoch has been taken: the idle
    # path (no epoch in flight, or its queue drained) must not allocate
    "ompi_tpu_torch/cr/ckpt.py": (
        "Engine.tick",
    ),
    # the gray-failure health scoring tick rides a pool's heartbeat
    # sweep whenever health_enable is on: integer EWMA reads,
    # threshold compares and streak counters over preallocated
    # per-host lists.  Transitions only LATCH here (pending[h] = 1);
    # the pvars and the degraded mask follow off-path, in collect
    "ompi_tpu_torch/obs/health.py": (
        "HealthPlane.tick",
    ),
    # the fleet-controller decision tick rides the same sampled
    # progress sweeps as Scraper.tick on every resident pool
    # rank-thread: gate-first, integer decisions only — resizes and
    # event recording happen in apply(), off this path
    "ompi_tpu_torch/serve/controller.py": (
        "FleetController.tick",
    ),
    # the resident pool's loops: the session-journal flush tick rides
    # the heartbeat loop every period for the life of the pool (a
    # dirty-flag check, allocation-free when nothing is pending), and
    # the progress-stall watchdog scan ticks at obs_watchdog_ms/2 when
    # armed (integer compares over the session table; the capture
    # lives off-path in _watchdog_collect); on a pool of several host
    # domains the host-liveness sweep rides the heartbeat loop too
    # (integer arithmetic over the preallocated per-host lists; the
    # declaration lives off-path in _host_collect)
    "ompi_tpu_torch/tools/dvm.py": (
        "_Journal.tick",
        "DVMServer._watchdog_tick",
        "DVMServer._host_tick",
    ),
}

_BANNED_BUILTIN_CALLS = ("dict", "list", "set", "tuple", "frozenset")


class _HotVisitor(ast.NodeVisitor):
    def __init__(self, fname: str, func: str) -> None:
        self.fname = fname
        self.func = func
        self.violations: List[str] = []

    def _flag(self, node: ast.AST, what: str) -> None:
        self.violations.append(
            f"{self.fname}:{node.lineno}: {self.func}: {what}")

    # -- container allocations ------------------------------------------
    def visit_Tuple(self, node: ast.Tuple) -> None:
        if isinstance(node.ctx, ast.Load):
            self._flag(node, "tuple allocation")
        self.generic_visit(node)

    def visit_List(self, node: ast.List) -> None:
        if isinstance(node.ctx, ast.Load):
            self._flag(node, "list allocation")
        self.generic_visit(node)

    def visit_Dict(self, node: ast.Dict) -> None:
        self._flag(node, "dict allocation")
        self.generic_visit(node)

    def visit_Set(self, node: ast.Set) -> None:
        self._flag(node, "set allocation")
        self.generic_visit(node)

    def visit_ListComp(self, node: ast.ListComp) -> None:
        self._flag(node, "list comprehension")
        self.generic_visit(node)

    def visit_SetComp(self, node: ast.SetComp) -> None:
        self._flag(node, "set comprehension")
        self.generic_visit(node)

    def visit_DictComp(self, node: ast.DictComp) -> None:
        self._flag(node, "dict comprehension")
        self.generic_visit(node)

    def visit_GeneratorExp(self, node: ast.GeneratorExp) -> None:
        self._flag(node, "generator expression")
        self.generic_visit(node)

    # -- string building ------------------------------------------------
    def visit_JoinedStr(self, node: ast.JoinedStr) -> None:
        self._flag(node, "f-string")
        self.generic_visit(node)

    # -- calls ----------------------------------------------------------
    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Name) and fn.id in _BANNED_BUILTIN_CALLS:
            self._flag(node, f"call to {fn.id}()")
        if isinstance(fn, ast.Attribute) and fn.attr == "format":
            self._flag(node, "str.format call")
        self.generic_visit(node)

    # -- wall clock ------------------------------------------------------
    def visit_Attribute(self, node: ast.Attribute) -> None:
        if (node.attr == "time"
                and isinstance(node.value, ast.Name)
                and node.value.id == "time"):
            self._flag(node, "time.time reference")
        self.generic_visit(node)


def _iter_functions(tree: ast.Module):
    """Yield (qualified_name, node) for module-level functions and
    class methods (one nesting level — the audit scope)."""
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name, node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, (ast.FunctionDef,
                                    ast.AsyncFunctionDef)):
                    yield f"{node.name}.{sub.name}", sub


def audit_source(src: str, funcnames: Tuple[str, ...],
                 fname: str = "<source>") -> List[str]:
    """Audit the given source text; returns violation strings and a
    line per declared hot function that was not found (a renamed hot
    function silently escaping the audit is itself a failure)."""
    tree = ast.parse(src, filename=fname)
    found = {}
    for qual, node in _iter_functions(tree):
        if qual in funcnames:
            found[qual] = node
    out: List[str] = []
    for qual in funcnames:
        node = found.get(qual)
        if node is None:
            out.append(f"{fname}: hot function {qual} not found "
                       f"(renamed? update HOT_FUNCTIONS)")
            continue
        v = _HotVisitor(fname, qual)
        # visit body + defaults (a mutable/allocating default is read
        # at def time, but a time.time default smuggles the banned
        # clock into the call path)
        v.visit(node)
        out.extend(v.violations)
    return out


def audit() -> List[str]:
    """Audit every declared hot function in the live source tree."""
    import ompi_tpu_torch
    import os
    root = os.path.dirname(os.path.dirname(
        os.path.abspath(ompi_tpu_torch.__file__)))
    out: List[str] = []
    for rel, funcs in HOT_FUNCTIONS.items():
        path = os.path.join(root, rel)
        with open(path) as fh:
            src = fh.read()
        out.extend(audit_source(src, funcs, fname=rel))
    return out


def main(argv=None) -> int:
    violations = audit()
    for v in violations:
        sys.stdout.write(v + "\n")
    if violations:
        sys.stdout.write(f"hotpath_audit: {len(violations)} "
                         f"violation(s)\n")
        return 1
    n = sum(len(f) for f in HOT_FUNCTIONS.values())
    sys.stdout.write(f"hotpath_audit: {n} hot functions clean\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
