"""Serving control plane of the resident pool (tools/dvm.py).

Port of the reference's ``ompi_tpu/serve``.  The pool gives many
sessions one resident set of rank-threads; this package keeps it
healthy under overload:

- ``quota``       — per-session HBM deposit budgets, attributed through
                    the obs cid bands and charged at the device deposit
                    (coll/device.py ``_deposit``): a first breach is
                    recorded, a continued one fails that run with a
                    typed ``QuotaExceeded`` — a greedy tenant never
                    poisons the pool.
- ``controller``  — FleetController, the closed loop: an audit-clean
                    ``tick()`` on the sampled progress sweeps of the
                    resident ranks reads queue depth and utilization and
                    decides pool resizes and shed margins; the pool's
                    heartbeat loop applies the decisions off the hot
                    path.

Admission policy itself (priorities, preemption, deadline shedding)
lives in tools/dvm.py next to the queue it governs.
"""

from ompi_tpu_torch.serve.controller import FleetController  # noqa: F401
from ompi_tpu_torch.serve.quota import (QuotaExceeded,  # noqa: F401
                                        begin_run, charge_hbm, install)
