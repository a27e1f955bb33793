"""Silent-data-corruption plane for device collectives.

Port of the reference's obs/integrity.py.  A chip that computes wrong
answers while passing every heartbeat is caught by an online, sampled,
algebraic check that rides the collective rendezvous:

    gate      each rank digests its own contribution at deposit time —
              exact modular sum for int dtypes, float64 sum with a
              relative tolerance band for floats, exact extremum for
              MAX/MIN — and wraps its deposit in a ``_Checked`` carrier;
    verify    the executing rank (the last arriver, or the dispatcher
              thread) cross-checks the fold of the per-rank claims
              against the digest of the reduced data: exact for int
              SUM (mod 2^width), MAX and MIN, within a band for float
              SUM;
    bisect    on mismatch, every rank's deposited operand is digested
              again and compared with its claim at zero tolerance; a
              divergent rank corrupted its operand after the gate and
              is convicted, none divergent convicts the executing rank;
    survive   the op is retried from the pristine sources (a
              byte-identical result, never a failed job) and the
              conviction goes to the registered hooks.

The digests are K11 (kernels/digest.py) on the operands' own device:
no operand crosses to the host.  The gate's claim stays on the card as
an 8-byte result; the executing rank brings every claim and every
output digest to the host in one copy a device, after its stream has
waited on the deposits.  The pristine source is a clone on the
depositor's device and stream (the reference keeps a host copy).

Sampling is comm-consistent without communication: every rank keeps
an identical per-comm countdown over an identical op sequence, so
either every rank wraps an op or none does.  The period starts at 1
and doubles toward ``integrity_sample`` every ``integrity_sample_auto``
banked checks.

Divergences from the reference, pinned by tests: the source stays on
the device; a K11 build or launch error raises (only the comparison of
digests fails open, where the reference fails open on everything).
A mismatch, a conviction and a retry each leave a flight-recorder event
(``obs.EV_SDC_MISMATCH``, ``EV_SDC_CONVICT``, ``EV_SDC_RETRY``).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ompi_tpu_torch import convert
from ompi_tpu_torch.kernels import digest as _k11
from ompi_tpu_torch.mca.params import registry

_enable_var = registry.register(
    "integrity", "", "enable", 0, int,
    help="Arm the SDC-detection plane for device collectives: sampled "
         "algebraic checksum cross-checks on the rendezvous path, "
         "bisection attribution, retry-from-source and conviction on "
         "mismatch")
_sample_var = registry.register(
    "integrity", "", "sample", 64, int,
    help="Steady-state check sampling period cap (1-in-N sampled "
         "collectives carry an integrity check; 1 = every op).  The "
         "live period starts at 1 and doubles toward this cap as "
         "clean checks bank up")
_sample_auto_var = registry.register(
    "integrity", "", "sample_auto", 256, int,
    help="Banked clean checks per period doubling (adaptive sampler "
         "ramp rate); 0 pins the period at integrity_sample")
_rel_tol_var = registry.register(
    "integrity", "", "rel_tol", 1e-4, float,
    help="Relative tolerance band for float SUM digests (reassociated "
         "device reductions round differently from the float64 fold; "
         "int/MAX/MIN digests are exact and ignore this)")

_pv_checks = registry.register_pvar(
    "integrity", "", "checks",
    help="Device-collective ops that carried a sampled integrity "
         "check (gate + verify both counted here once)")
_pv_mismatches = registry.register_pvar(
    "integrity", "", "mismatches",
    help="Integrity checks whose reduced-data digest disagreed with "
         "the fold of per-rank claims (each triggers bisection)")
_pv_convictions = registry.register_pvar(
    "integrity", "", "convictions",
    help="Chips convicted of silent data corruption by the bisection "
         "round (attributed to a specific rank/host)")
_pv_retries = registry.register_pvar(
    "integrity", "", "retry_ops",
    help="Poisoned collectives re-executed from pristine per-rank "
         "sources after a conviction (byte-identical recovery)")

#: module arm flag — a plain attribute so the coll hot path pays one
#: module-dict lookup (``_ig.on``) per op when the plane is off.
on = False

#: live sampler parameters, cached from the knobs at refresh() time
_cap = 64
_auto = 256
_rel_tol = 1e-4

#: fold codes — the digest algebra each spec selects (K11's codes)
F_INTSUM, F_FSUM, F_MAX, F_MIN = (_k11.F_INTSUM, _k11.F_FSUM, _k11.F_MAX,
                                  _k11.F_MIN)

#: process-global conviction registry and its listeners
_conv_lock = threading.Lock()
convicted: List[Dict[str, Any]] = []
_hooks: List[Callable[[Dict[str, Any]], None]] = []

_INTS = (torch.int8, torch.uint8, torch.int16, torch.uint16, torch.int32,
         torch.uint32, torch.int64, torch.uint64)
_FLOATS = (torch.float16, torch.float32, torch.float64)


def refresh() -> None:
    """Re-read the knobs into the cached module globals.  Called from
    mpi_init and directly by tests after twiddling integrity_* knobs
    mid-process."""
    global on, _cap, _auto, _rel_tol
    _cap = max(1, int(_sample_var.value or 1))
    _auto = max(0, int(_sample_auto_var.value or 0))
    _rel_tol = float(_rel_tol_var.value or 0.0)
    on = bool(_enable_var.value)


def set_armed(flag: bool) -> None:
    """Arm or disarm without touching the knobs (benchmark toggle)."""
    global on
    on = bool(flag)


def install_convict_hook(fn: Callable[[Dict[str, Any]], None]) -> None:
    """Register a conviction listener.  Idempotent per function."""
    with _conv_lock:
        if fn not in _hooks:
            _hooks.append(fn)


def remove_convict_hook(fn: Callable[[Dict[str, Any]], None]) -> None:
    with _conv_lock:
        if fn in _hooks:
            _hooks.remove(fn)


def convicted_snapshot() -> List[Dict[str, Any]]:
    """Copy of the conviction registry."""
    with _conv_lock:
        return [dict(r) for r in convicted]


def reset() -> None:
    """Clear the conviction registry (sampler state is per comm and
    dies with the world)."""
    with _conv_lock:
        del convicted[:]


# -- spec construction (what can be checked, and how) ------------------------

def _dtype_of(x):
    """The torch dtype of a tensor, a numpy-like buffer or a dtype;
    None when torch has none."""
    if isinstance(x, torch.dtype):
        return x
    dt = getattr(x, "dtype", None)
    if isinstance(dt, torch.dtype):
        return dt
    try:
        return convert.torch_dtype(dt if dt is not None
                                   else np.asarray(x).dtype)
    except (KeyError, TypeError):
        return None


def spec(kind: str, opname: str, x: Any, root: int = 0):
    """The check spec of one collective, or None when the op is not
    algebraically checkable (another reduce op, a dtype the digest does
    not take).  It depends only on (kind, opname, dtype), so every rank
    derives the same spec.

    Spec tuple: ``(kind, foldcode, itemsize[, root])``."""
    if not on:
        return None
    return spec_static(kind, opname, x, root)


def spec_static(kind: str, opname: str, x: Any, root: int = 0):
    """spec() without the arm-flag gate — for cached Plan objects that
    outlive arm/disarm; their executor re-gates on ``on`` per call.
    ``x``: a tensor, a numpy-like buffer, or a torch dtype.  bool is
    excluded (reductions treat bool SUM as OR); so are complex and
    bfloat16, which the reference never checks (numpy sees its
    bfloat16 as kind 'V')."""
    dt = _dtype_of(x)
    if dt in _INTS:
        base = F_INTSUM
    elif dt in _FLOATS:
        base = F_FSUM
    else:
        return None
    if kind in ("allreduce", "redscat"):
        if opname == "MPI_SUM":
            return (kind, base, dt.itemsize)
        if opname == "MPI_MAX":
            return (kind, F_MAX, dt.itemsize)
        if opname == "MPI_MIN":
            return (kind, F_MIN, dt.itemsize)
        return None
    if kind in ("gather", "alltoall"):
        # conservation checks: the op moves data without combining it,
        # so total content (modular/float sum) is invariant
        return (kind, base, dt.itemsize)
    if kind == "bcast":
        return (kind, base, dt.itemsize, int(root))
    return None


# -- digests (the per-operand checksums) -------------------------------------

def digest(x: torch.Tensor, code: int):
    """Checksum one operand (K11 on a card, its plain version on the
    CPU): int dtypes fold as a uint64 modular sum of their bytes viewed
    unsigned, floats in float64, MAX/MIN exact.  Synchronises with the
    host: the checked path itself reads digests through ``_digests``."""
    x = x.contiguous()
    raw = _k11.digest([x.reshape(-1)], [code])
    return _k11.decode(raw.tolist()[0], code, x.dtype)


def _fold_claims(code: int, ds: List[Any]):
    """Combine per-rank claims with the same algebra the reduction
    used (python-int exact for modular sums)."""
    if code in (F_INTSUM, F_FSUM):
        t = 0
        for d in ds:
            t += d
        return t
    if code == F_MAX:
        return max(ds)
    return min(ds)


def _eq(code: int, a, b, itemsize: int, tol: float) -> bool:
    if code == F_INTSUM:
        m = (1 << (8 * itemsize)) - 1
        return (int(a) & m) == (int(b) & m)
    try:
        fa, fb = float(a), float(b)
    except (TypeError, ValueError):
        return a == b
    if fa != fa or fb != fb or fa in (float("inf"), float("-inf")) \
            or fb in (float("inf"), float("-inf")):
        # non-finite digests are unjudgeable (NaN-poisoned data is a
        # model problem, not chip corruption) — fail open
        return True
    if code == F_FSUM and tol > 0.0:
        return abs(fa - fb) <= tol * max(abs(fa), abs(fb), 1.0)
    return fa == fb


# -- sampling (per-op hot path) ----------------------------------------------

def _new_state(comm):
    # countdown, live period, banked clean checks; in the comm's
    # instance dict so each world starts fresh and sibling comms sample
    # independently
    st = [0, 1, 0]
    comm.__dict__["_ig_state"] = st
    return st


def sample(comm):
    """Deterministic 1-in-N sampling decision for the next collective
    on ``comm``: every rank advances an identical counter over an
    identical op sequence, so the decision is comm-consistent without
    communication."""
    st = comm.__dict__.get("_ig_state")
    if st is None:
        st = _new_state(comm)
    c = st[0]
    if c > 0:
        st[0] = c - 1
        return 0
    p = st[1]
    b = st[2] + 1
    st[2] = b
    if _auto > 0 and b >= _auto and p < _cap:
        p = p + p
        if p > _cap:
            p = _cap
        st[1] = p
        st[2] = 0
    st[0] = p - 1
    return 1


# -- deposits: what a gate digests and a flip corrupts -----------------------

def _parts(value):
    """(operands, rebuild) of a deposit: the tensors the gate digests
    and a flip may corrupt, and how to rebuild the deposit around
    replacements.  A deposit is one tensor, a fused batch's (signature,
    tensors), or a mesh segment's (operand, output) pair, whose output
    is the destination the body writes, never an operand."""
    if isinstance(value, torch.Tensor):
        return [value], lambda ts: ts[0]
    head, tail = value
    if isinstance(tail, list):
        return list(tail), lambda ts: (head, ts)
    return [head], lambda ts: (ts[0], tail)


def _claim_ops(ck, value):
    """(tensors, codes) of a deposit's claim, in claim order: one
    operand, or for a fused batch one an entry."""
    ts = _parts(value)[0]
    if ck[0] == "fused":
        return [ts[e[2]] for e in ck[1]], [e[1] for e in ck[1]]
    return ts[:1], [ck[1]]


def _out_ops(ck, outs):
    """(tensors, codes) of the outputs a verify digests, in the order
    ``_verify`` reads them."""
    kind = ck[0]
    if kind == "fused":
        out0, ts, codes = outs[0], [], []
        for ent in ck[1]:
            idx = ent[3] if ent[0] == "g" else (ent[2],)
            ts += [out0[i] for i in idx]
            codes += [ent[1]] * len(idx)
        return ts, codes
    if kind in ("redscat", "alltoall"):
        return list(outs), [ck[1]] * len(outs)
    return [outs[0]], [ck[1]]


def _claim(ck, value) -> torch.Tensor:
    """The gate's claim: K11 over the deposit's claim operands on the
    depositor's device and current stream; stays there."""
    ts, codes = _claim_ops(ck, value)
    return _k11.digest([t.reshape(-1) for t in ts], codes)


def _fetch(tensors: List[torch.Tensor]) -> List[List[int]]:
    """Every int64 result tensor to the host, one copy a device."""
    by_dev: Dict[Any, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dev.setdefault(t.device, []).append(i)
    out: List[List[int]] = [[] for _ in tensors]
    for idx in by_dev.values():
        flat = torch.cat([tensors[i] for i in idx]).tolist()
        lo = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[lo:lo + n]
            lo += n
    return out


def _digests(ts: List[torch.Tensor], codes: List[int], claims=()):
    """K11 over ``ts`` (``codes[i]`` for ``ts[i]``), one table launch a
    device, then those results and the claim tensors ``claims`` to the
    host in one copy a device.  Returns (raw results of ts, raw claims,
    one list a claim tensor)."""
    by_dev: Dict[Any, List[int]] = {}
    for i, t in enumerate(ts):
        by_dev.setdefault(t.device, []).append(i)
    tables, where = [], [None] * len(ts)
    for idx in by_dev.values():
        tables.append(_k11.digest(
            [ts[i].contiguous().reshape(-1) for i in idx],
            [codes[i] for i in idx]))
        for j, i in enumerate(idx):
            where[i] = (len(tables) - 1, j)
    got = _fetch(list(claims) + tables)
    cl, tab = got[:len(claims)], got[len(claims):]
    return [tab[t][j] for t, j in where], cl


def _values(ck, value, raw: List[int]):
    """Decode one deposit's raw claim: the value (a tuple of one an
    entry for a fused batch)."""
    ts, codes = _claim_ops(ck, value)
    vals = _k11.values(raw, codes, [t.dtype for t in ts])
    return tuple(vals) if ck[0] == "fused" else vals[0]


# -- the gate (wrap a sampled op) --------------------------------------------

class _Checked:
    """Per-rank deposit carrier for a sampled op: ``v`` is what enters
    the datapath (the device_sdc injector retargets this binding to a
    corrupted copy — the source stays pristine), ``src`` a pristine
    clone on the depositor's device for the retry, ``d`` the claim the
    gate made (K11's raw results, on that device)."""

    __slots__ = ("v", "src", "d", "rank")

    def __init__(self, v, src, d, rank):
        self.v = v
        self.src = src
        self.d = d
        self.rank = rank


def gate(comm, value, fn, ck):
    """Wrap (value, fn) for one sampled collective.  Returns the pair
    unchanged when this op is not sampled.  Called from the coll meet
    path only when a spec exists (the plane is armed)."""
    if not sample(comm):
        return value, fn
    _pv_checks.add(1)
    ts, rebuild = _parts(value)
    src = rebuild([t.clone(memory_format=torch.contiguous_format)
                   for t in ts])
    c = _Checked(value, src, _claim(ck, src), comm.rank)

    def checked_fn(shards, _fn=fn, _ck=ck, _comm=comm):
        return _run_checked(_comm, _fn, _ck, shards)

    return c, checked_fn


# -- verify / bisect / convict / retry (executing-rank side) -----------------

def _run_checked(comm, fn, ck, shards):
    outs = fn([s.v for s in shards])
    # the digests are computed and read outside the fail-open clause: a
    # K11 build or launch error raises
    ots, codes = _out_ops(ck, outs)
    outd, raw = _digests(ots, codes, [s.d for s in shards])
    try:
        claims = [_values(ck, s.src, r) for s, r in zip(shards, raw)]
        outv = _k11.values(outd, codes, [t.dtype for t in ots])
        ok = _verify(ck, claims, outv)
    except Exception:  # noqa: BLE001
        # a defect in the comparison must never take down the datapath
        # (the plane's contract is "never a failed job"): fail open
        return outs
    if ok:
        return outs
    _pv_mismatches.add(1)
    from ompi_tpu_torch import obs as _obs
    _obs.record_event(_obs.EV_SDC_MISMATCH, getattr(comm, "cid", 0),
                      int(getattr(comm, "_dev_seq", 0)),
                      _obs.intern(ck[0]), rank=comm.rank)
    bad = _bisect(ck, shards, claims)
    if bad < 0:
        # no rank's operand diverged from its gate claim: the
        # reduction itself was computed wrong — the executing chip
        # (this one) is the culprit
        bad = comm.rank
    _convict(comm, bad, ck[0])
    outs = fn([s.src for s in shards])
    _pv_retries.add(1)
    _obs.record_event(_obs.EV_SDC_RETRY, getattr(comm, "cid", 0),
                      int(getattr(comm, "_dev_seq", 0)), bad,
                      rank=comm.rank)
    return outs


def _verify(ck, claims, outv) -> bool:
    """Claims (one value a rank, a tuple for a fused batch) against the
    output digests ``outv`` (``_out_ops`` order)."""
    kind = ck[0]
    if kind == "fused":
        k = 0
        for ent in ck[1]:
            ekind, code, ci = ent[0], ent[1], ent[2]
            if ekind == "g":
                parts = outv[k:k + len(ent[3])]
                k += len(ent[3])
                if not _eq(code, _fold_claims(code, [c[ci] for c in claims]),
                           _fold_claims(code, parts), ent[4], _rel_tol):
                    return False
            else:
                # hbm bcast entry: an exact root-claim match
                if not _eq(code, claims[ent[3]][ci], outv[k], ent[4], 0.0):
                    return False
                k += 1
        return True
    code, isz = ck[1], ck[2]
    if kind == "bcast":
        # bcast moves bytes verbatim: digests of identical data are
        # identical, so the compare is exact even for floats
        return _eq(code, claims[ck[3]], outv[0], isz, 0.0)
    if kind in ("allreduce", "redscat", "gather", "alltoall"):
        return _eq(code, _fold_claims(code, claims),
                   _fold_claims(code, outv), isz, _rel_tol)
    return True


def _bisect(ck, shards, claims) -> int:
    """Attribution round: digest every rank's deposited operand (the
    value that actually entered the datapath) again, one K11 table a
    device, and compare it with the claim it made at the gate.  A
    diverging rank corrupted its operand in the detection window —
    convict it.  Returns -1 when every operand still matches its claim
    (compute-side corruption)."""
    ts, codes, spans = [], [], []
    for s in shards:
        t, c = _claim_ops(ck, s.v)
        spans.append((len(ts), len(t)))
        ts += t
        codes += c
    raw, _ = _digests(ts, codes)
    for r, (s, (lo, n)) in enumerate(zip(shards, spans)):
        d2 = _values(ck, s.v, raw[lo:lo + n])
        if ck[0] == "fused":
            if d2 != claims[r]:
                return r
        elif not _eq(ck[1], d2, claims[r], ck[2], 0.0):
            return r
    return -1


def _convict(comm, rank: int, kind: str) -> None:
    grank = rank
    host = 0
    try:
        grank = comm.group[rank]
        st = comm._peer_state(grank)
        host = int(getattr(getattr(st, "rte", None), "node_id", 0) or 0)
    except Exception:  # noqa: BLE001
        pass
    _pv_convictions.add(1)
    rec = {"rank": int(grank), "host": host,
           "cid": int(getattr(comm, "cid", 0)), "kind": kind}
    from ompi_tpu_torch import obs as _obs
    _obs.record_event(_obs.EV_SDC_CONVICT, int(grank), host,
                      _obs.intern(kind), rank=comm.rank)
    with _conv_lock:
        convicted.append(rec)
        hooks = list(_hooks)
    for h in hooks:
        try:
            h(rec)
        except Exception:  # noqa: BLE001
            pass


# -- fault-injection support -------------------------------------------------

def flip_value(value):
    """Corrupt one operand the way a bad chip would: flip a high
    mantissa/magnitude bit of the middle element.  Understands the
    ``_Checked`` carrier (retargets ``.v``, leaving ``.src`` and the
    gate claim pristine — exactly the divergence _bisect attributes),
    fused-batch deposits and mesh segment pairs.  On an unwrapped value
    (op not sampled) the corruption is silent — the honest semantics
    of sampled detection."""
    if isinstance(value, _Checked):
        value.v = _flip_inner(value.v)
        return value
    return _flip_inner(value)


def _flip_inner(value):
    if value is None:
        return value  # a barrier's deposit carries no operand
    if isinstance(value, np.ndarray):
        return _flip_host(value)  # coll/sm's host deposit
    ts, rebuild = _parts(value)
    return rebuild([_flip_array(ts[0])] + ts[1:])


def _flip_host(x: np.ndarray) -> np.ndarray:
    """``_flip_array`` of a numpy deposit, byte for byte the
    reference's: a corrupted copy, the depositor's array untouched."""
    if x.size == 0:
        return x
    flat = np.ascontiguousarray(x).copy()
    bv = flat.view(np.uint8).reshape(-1)
    isz = max(1, x.dtype.itemsize)
    bv[(x.size // 2) * isz + isz - 1] ^= 0x40
    return flat.reshape(x.shape)


def _flip_array(x: torch.Tensor) -> torch.Tensor:
    """A corrupted copy of ``x`` on its device (the caller's tensor is
    never written)."""
    if x.numel() == 0:
        return x
    flat = x.clone(memory_format=torch.contiguous_format)
    bv = flat.view(-1).view(torch.uint8)
    isz = max(1, x.element_size())
    # last byte of the middle element: sign/exponent/high-magnitude
    # bits live there on little-endian, so SUM/MAX/MIN digests all see
    # the flip
    mid = (x.numel() // 2) * isz + isz - 1
    bv[mid] ^= 0x40
    return flat
