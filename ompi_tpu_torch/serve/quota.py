"""Per-session resource quotas for the resident pool.

Port of the reference's ``ompi_tpu/serve/quota.py``.  Attribution rides
the obs cid bands: every rank-thread of session N runs with
``state.cid_band == N``, so ``obs.current_band()`` inside a deposit IS
the tenant — no per-callsite plumbing.

One budget, off by default (0 = unlimited): ``dvm_quota_hbm_bytes``,
host-to-device deposit bytes a run.  The reference's second budget,
``dvm_quota_cache_share_pct`` (one session's share of its compiled-
collective cache), has nothing to bound in the port (no compiled-
program cache: its kernels are built libraries every session shares),
so :func:`install` refuses a pool started with it nonzero rather than
accept a bound that is not in force.

Enforcement is degrade-then-reject: the FIRST breach of the HBM budget
is the degrade step, a continued breach raises :class:`QuotaExceeded`,
which fails that one run through the session-confined abort path — the
pool and every other tenant keep going.  The reference's degrade step
drops the offender's compiled executables from its cache; the port has
none to drop, so its degrade step records the ``dvm_quota``
(``hbm_degrade``) flight event and evicts nothing.

The charge tap is installed into coll/device lazily (``install()``): a
world outside the pool never imports this module and pays one None
check per deposit.
"""

from __future__ import annotations

import threading

from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch.mca.params import registry

MAX_BANDS = _obs.MAX_BANDS

_hbm_var = registry.register(
    "dvm", "quota", "hbm_bytes", 0,
    help="Per-run HBM deposit budget per session, bytes (0 = "
         "unlimited).  The first breach is recorded (the degrade "
         "step); a continued breach raises QuotaExceeded, failing only "
         "that session's run.")
_share_var = registry.register(
    "dvm", "quota", "cache_share_pct", 0,
    help="The reference's cap on one session's share of its compiled-"
         "collective cache.  The port has no such cache: a pool "
         "started with it nonzero is refused.")

# deposited bytes per band — the gauge operators watch to see WHO is
# filling HBM, and the counter the budget is checked against
pv_hbm = _obs.scoped_pvar(
    "serve", "quota", "hbm_bytes",
    help="Host-to-device deposit bytes attributed per session band")
pv_rejects = _obs.scoped_pvar(
    "dvm", "quota", "rejects",
    help="Runs failed by QuotaExceeded (HBM budget breached after the "
         "degrade step), per session band")


class QuotaExceeded(RuntimeError):
    """Typed per-session budget breach.  Raised from the deposit path
    after the degrade step already ran; the session abort machinery
    confines it to the offending run."""

    def __init__(self, band: int, kind: str, used: int, budget: int):
        super().__init__(
            "session band %d over %s quota: %d > %d bytes"
            % (band, kind, used, budget))
        self.band = band
        self.kind = kind
        self.used = used
        self.budget = budget


_lock = threading.Lock()
# per-band bytes charged since begin_run; parallel degraded flag
_charged = [0] * MAX_BANDS
_degraded = [0] * MAX_BANDS
_installed = False


def install() -> None:
    """Point coll/device's deposit tap at charge_hbm.  Idempotent; the
    pool calls this once at startup, before it binds anything.  Raises
    ValueError if ``dvm_quota_cache_share_pct`` is nonzero."""
    global _installed
    if _share_var.value:
        raise ValueError(
            "dvm_quota_cache_share_pct=%s: the port has no compiled-"
            "program cache for a session's share to bound (its kernels "
            "are built libraries every session shares); start the pool "
            "with it at 0" % _share_var.value)
    from ompi_tpu_torch.coll import device as _device
    _device._hbm_charge_hook = charge_hbm
    _installed = True


def begin_run(band: int) -> None:
    """Zero the band's budget window — quotas are per *run*, so a
    well-behaved session is never haunted by its previous job."""
    if not 0 <= band < MAX_BANDS:
        return
    with _lock:
        _charged[band] = 0
        _degraded[band] = 0


def charge_hbm(nbytes: int) -> None:
    """Account a host-to-device deposit to the calling thread's session
    band, then enforce the budget: degrade on the first breach, raise
    :class:`QuotaExceeded` on the next."""
    band = _obs.current_band()
    pv_hbm.add(nbytes, band)
    if band == 0:
        return
    budget = _hbm_var.value
    if not budget or budget <= 0:
        return
    with _lock:
        _charged[band] += nbytes
        used = _charged[band]
        if used <= budget:
            return
        first = not _degraded[band]
        _degraded[band] = 1
    if first:
        # degrade: the reference evicts the offender's own compiled
        # executables here; the port has no compiled-program cache, so
        # the step is the record alone
        _obs.record_event(_obs.EV_DVM_QUOTA, band,
                          _obs.intern("hbm_degrade"), used)
        return
    pv_rejects.add(1, band)
    _obs.record_event(_obs.EV_DVM_QUOTA, band,
                      _obs.intern("hbm_reject"), used)
    raise QuotaExceeded(band, "hbm", used, budget)
