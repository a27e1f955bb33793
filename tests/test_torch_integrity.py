"""The integrity (silent-data-corruption) plane through both packages:
ompi_tpu.obs.integrity and its port, ompi_tpu_torch.obs.integrity
(the digest on K11's plain version here, on the CPU), with the
ft_inject ``device_sdc`` injector that exercises it.

Mirrors the CPU cases of tests/test_integrity.py: the digest algebra,
spec gating, the sampler, detect / convict / retry on both device
tiers (the port's mesh on logical devices of the CPU, its coll/hbm on
torch.device("cpu")) and for fused batches, the clean run, the
executing-rank conviction, fail-open, the injector's sequence and the
flip's carrier.  The health plane, the doctor, wire CRCs, the buddy
tier, the chaos matrix and the hotpath audit are out of scope.

Tolerances: the digests of integer operands and every MAX / MIN digest
exactly; a float SUM digest within 1e-12 relative of numpy's (both sum
in float64, in different orders).  Collective results byte for byte
(the inputs are exact under any fold order).

Pinned divergences: the gate's pristine source and its claim stay on
the deposit's device (the reference keeps a host copy and a Python
value), and a digest kernel's error raises where the reference fails
open on every checker exception.
"""

import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import ompi_tpu.ft_inject as ref_fi
from ompi_tpu.coll import fusion as ref_fusion
from ompi_tpu.mca.params import registry as ref_registry
from ompi_tpu.obs import integrity as ref_ig
from ompi_tpu.op import op as ref_op
from ompi_tpu.testing import run_ranks as ref_run_ranks
from ompi_tpu_torch import convert
from ompi_tpu_torch import ft_inject as port_fi
from ompi_tpu_torch.coll import fusion as port_fusion
from ompi_tpu_torch.kernels import digest as k11
from ompi_tpu_torch.mca.params import registry as port_registry
from ompi_tpu_torch.obs import integrity as ig
from ompi_tpu_torch.op import op as port_op
from ompi_tpu_torch.testing import logical_devices
from ompi_tpu_torch.testing import run_ranks as port_run_ranks

CPU = torch.device("cpu")

ARM = {"integrity_enable": 1, "integrity_sample": 1,
       "integrity_sample_auto": 0}
INJECT = dict(ARM, **{"ft_inject_plan": "device_sdc:1",
                      "ft_inject_victim_rank": "1",
                      "ft_inject_sdc_period": 1})
PVARS = ("integrity_checks", "integrity_mismatches",
         "integrity_convictions", "integrity_retry_ops")


class armed:
    """Set knobs in both registries, refresh both planes and clear
    both conviction registries; restore and clear on exit."""

    def __init__(self, vals) -> None:
        self.vals = vals

    def __enter__(self):
        self.saved = [(reg, {k: reg.get(k) for k in self.vals})
                      for reg in (ref_registry, port_registry)]
        for reg, _ in self.saved:
            for k, v in self.vals.items():
                reg.set(k, v)
        for plane in (ref_ig, ig):
            plane.refresh()
            plane.reset()
        return self

    def __exit__(self, *exc):
        for reg, saved in self.saved:
            for k, v in saved.items():
                reg.set(k, v)
        for plane in (ref_ig, ig):
            plane.refresh()
            plane.reset()


def _pv(reg, name):
    return reg._pvars[name].read()


def _convicted(plane):
    return sorted({r["rank"] for r in plane.convicted_snapshot()})


def _np(x):
    return convert.to_numpy(x) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _t(a):
    return convert.to_torch(np.asarray(a), CPU)


# -- the digest algebra -------------------------------------------------------

DIGEST_DTYPES = [np.int8, np.uint8, np.int16, np.uint16, np.int32,
                 np.uint32, np.int64, np.uint64, np.float16, np.float32,
                 np.float64]


def _operand(rng, dt, n):
    dt = np.dtype(dt)
    if dt.kind == "f":
        a = (rng.standard_normal(n) * 1000).astype(dt)
        if n >= 8:
            a[1], a[3], a[5] = -0.0, np.inf, -np.inf
        return a
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, size=n, dtype=dt,
                        endpoint=True)


def _same_digest(code, got, want):
    if code == ig.F_FSUM and not (np.isinf(want) or np.isnan(want)):
        return abs(got - want) <= 1e-12 * max(abs(got), abs(want))
    return got == want or (got != got and want != want)


@pytest.mark.parametrize("dt", DIGEST_DTYPES, ids=lambda d: np.dtype(d).name)
def test_digest_matches_reference(dt):
    """Every fold the dtype takes, over lengths 0, 1, 2, 1000 and
    2**17 + 3 (signed zeros and infinities among the floats, NaN in a
    second float operand): ints and MAX / MIN exact, float SUM within
    1e-12 relative; K11's table (one call, several operands) gives the
    same values as one operand at a time."""
    rng = np.random.default_rng(5)
    codes = ([ig.F_FSUM, ig.F_MAX, ig.F_MIN] if np.dtype(dt).kind == "f"
             else [ig.F_INTSUM, ig.F_MAX, ig.F_MIN])
    ops = [_operand(rng, dt, n) for n in (0, 1, 2, 1000, (1 << 17) + 3)]
    if np.dtype(dt).kind == "f":
        nan = _operand(rng, dt, 64)
        nan[7] = np.nan
        ops.append(nan)
    table, tcodes = [], []
    for a in ops:
        for code in codes:
            want = ref_ig.digest(a, code)
            got = ig.digest(_t(a), code)
            assert type(got) is type(want) or a.size == 0
            assert _same_digest(code, got, want), (a.size, code, got, want)
            table.append(_t(a))
            tcodes.append(code)
    raw = k11.digest(table, tcodes).tolist()
    vals = k11.values(raw, tcodes, [t.dtype for t in table])
    for t, code, v in zip(table, tcodes, vals):
        one = ig.digest(t, code)
        assert v == one or (v != v and one != one)


def test_digest_modular_int_exactness():
    """uint8 200 + 100 wraps to 44 on the device; the claims' fold
    matches it under the width mask, and 45 does not."""
    for plane, mk in ((ref_ig, np.asarray), (ig, _t)):
        da = plane.digest(mk(np.array([200], np.uint8)), plane.F_INTSUM)
        db = plane.digest(mk(np.array([100], np.uint8)), plane.F_INTSUM)
        good = plane.digest(mk(np.array([44], np.uint8)), plane.F_INTSUM)
        bad = plane.digest(mk(np.array([45], np.uint8)), plane.F_INTSUM)
        assert plane._eq(plane.F_INTSUM, da + db, good, 1, 0.0)
        assert not plane._eq(plane.F_INTSUM, da + db, bad, 1, 0.0)


@pytest.mark.parametrize("case", [
    (ig.F_FSUM, 1.0, 1.0 + 5e-5, 4, 1e-4),
    (ig.F_FSUM, 1.0, 1.001, 4, 1e-4),
    (ig.F_MAX, 9.0, 9.0, 4, 1e-4),
    (ig.F_MAX, 9.0, 9.0 + 1e-9, 4, 1e-4),
    (ig.F_FSUM, float("nan"), 1.0, 4, 1e-4),
    (ig.F_FSUM, float("inf"), 1.0, 4, 1e-4),
    (ig.F_INTSUM, 300, 44, 1, 0.0),
    (ig.F_INTSUM, -1, 0xFFFFFFFF, 4, 0.0),
])
def test_eq_matches_reference(case):
    """The tolerance band, exact MAX / MIN, fail-open on non-finite
    digests and the width mask, value for value the reference's."""
    assert ig._eq(*case) == ref_ig._eq(*case)


def test_digest_kinds_and_empty():
    x = _t(np.array([3, 9, 2], np.int32))
    assert ig.digest(x, ig.F_MAX) == 9
    assert ig.digest(x, ig.F_MIN) == 2
    assert ig.digest(torch.empty(0), ig.F_FSUM) == 0.0
    assert ig.digest(torch.empty(0, dtype=torch.int32), ig.F_INTSUM) == 0
    assert ig.digest(_t(np.array([-1], np.int32)), ig.F_INTSUM) \
        == 0xFFFFFFFF


# -- spec gating and sampling -------------------------------------------------

SPEC_DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32,
               np.uint32, np.int64, np.uint64, np.float16, np.float32,
               np.float64, np.complex64, ml_dtypes.bfloat16]
SPEC_CASES = [("allreduce", "MPI_SUM"), ("allreduce", "MPI_MAX"),
              ("allreduce", "MPI_MIN"), ("allreduce", "MPI_PROD"),
              ("allreduce", "MPI_BAND"), ("redscat", "MPI_SUM"),
              ("redscat", "MPI_MIN"), ("gather", ""), ("alltoall", ""),
              ("bcast", ""), ("ppermute", "")]


@pytest.mark.parametrize("dt", SPEC_DTYPES, ids=lambda d: np.dtype(d).name)
def test_spec_matches_reference(dt):
    """Armed, spec() classifies (kind, op, dtype) as the reference
    does — bool, complex and bfloat16 unchecked (numpy sees the
    reference's bfloat16 as kind 'V') — from a tensor, a numpy buffer
    or a dtype alike; unarmed it is None."""
    a = np.zeros(2, dt)
    with armed(ARM):
        for kind, opname in SPEC_CASES:
            want = ref_ig.spec(kind, opname, a, root=2)
            assert ig.spec(kind, opname, _t(a), root=2) == want
            assert ig.spec(kind, opname, a, root=2) == want
            assert ig.spec_static(kind, opname, convert.torch_dtype(a.dtype),
                                  root=2) == want
        ig.set_armed(False)
        assert ig.spec("allreduce", "MPI_SUM", _t(a)) is None


@pytest.mark.parametrize("cap,auto", [(8, 2), (64, 256), (1, 0), (4, 0)])
def test_sampler_sequence_matches_reference(cap, auto):
    """The per-comm countdown, adaptive ramp included, decides as the
    reference does at every op; two comms agree (comm consistency)."""
    saved = [(p, p._cap, p._auto) for p in (ref_ig, ig)]
    for p in (ref_ig, ig):
        p._cap, p._auto = cap, auto
    try:
        seqs = []
        for p in (ref_ig, ig, ig):
            c = types.SimpleNamespace()
            seqs.append([p.sample(c) for _ in range(600)])
        assert seqs[0] == seqs[1] == seqs[2]
        assert seqs[1][0] == 1
    finally:
        for p, c, a in saved:
            p._cap, p._auto = c, a


# -- detect / attribute / survive on both device tiers -----------------------

def _ref_mesh(n, fn):
    return ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(a, c.device), ref_op),
        devices=True)


def _ref_hbm(n, fn):
    return ref_run_ranks(
        n, lambda c: fn(c, lambda a: jax.device_put(a, c.device), ref_op),
        device_map=lambda r: jax.devices()[0])


def _port_mesh(n, fn):
    return port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                        port_op),
        device_map=logical_devices("cpu"))


def _port_hbm(n, fn):
    return port_run_ranks(
        n, lambda c: fn(c, lambda a: convert.to_torch(a, c.device),
                        port_op),
        device_map=lambda r: CPU)


RUNS = {"mesh": (_ref_mesh, _port_mesh), "hbm": (_ref_hbm, _port_hbm)}


def _op_mix(comm, put, op):
    """The op mix of tests/test_integrity.py's mesh case, returned as
    bytes: SUM f32, MAX int32, bcast from the victim, reduce_scatter
    SUM, allgather and alltoall int32."""
    r, size = comm.rank, comm.size
    out = [comm.allreduce_arr(put(np.full(32, r + 1, np.float32)), op.SUM),
           comm.allreduce_arr(put(np.full(8, (r + 1) * 100, np.int32)),
                              op.MAX),
           comm.bcast_arr(put(np.full(16, r * 10 + 7, np.float32)), root=1),
           comm.reduce_scatter_arr(put(np.full(size * 4, r + 1, np.float32)),
                                   op.SUM),
           comm.allgather_arr(put(np.full(2, r + 1, np.int32))),
           comm.alltoall_arr(put(np.full(size, r + 1, np.int32)))]
    return [_np(o).tobytes() for o in out]


def _op_mix_want(size):
    tot = size * (size + 1) // 2
    return [np.full(32, tot, np.float32).tobytes(),
            np.full(8, size * 100, np.int32).tobytes(),
            np.full(16, 17, np.float32).tobytes(),
            np.full(4, tot, np.float32).tobytes(),
            np.repeat(np.arange(1, size + 1, dtype=np.int32), 2).tobytes(),
            np.arange(1, size + 1, dtype=np.int32).tobytes()]


@pytest.mark.parametrize("tier", ["mesh", "hbm"])
def test_detect_convict_retry(tier):
    """device_sdc flips rank 1's operand at every collective; sampled
    1-in-1, every flip is detected, bisection convicts exactly rank 1
    and the retry from the pristine sources makes every result the
    analytic one, byte for byte — in both packages, with the same
    counts."""
    ref_run, port_run = RUNS[tier]
    counts = {}
    for name, run, reg, plane in (("ref", ref_run, ref_registry, ref_ig),
                                  ("port", port_run, port_registry, ig)):
        with armed(INJECT):
            base = {k: _pv(reg, k) for k in PVARS}
            res = run(4, _op_mix)
            assert all(r == _op_mix_want(4) for r in res), name
            assert _convicted(plane) == [1], name
            counts[name] = {k: _pv(reg, k) - base[k] for k in PVARS}
    assert counts["port"] == counts["ref"]
    c = counts["port"]
    assert c["integrity_mismatches"] == c["integrity_retry_ops"] \
        == c["integrity_convictions"] == 6
    assert c["integrity_checks"] == 6 * 4


def _fused(comm, put, op):
    r, size = comm.rank, comm.size
    qs = [comm.iallreduce_arr(put(np.full(16, r + 1, np.float32)), op.SUM),
          comm.iallreduce_arr(put(np.full(4, (r + 1) * 10, np.int32)),
                              op.MAX),
          comm.ibcast_arr(put(np.full(8, r * 2 + 3, np.int32)), 1 % size)]
    for q in qs:
        q.wait()
    return [_np(q.result).tobytes() for q in qs]


@pytest.mark.parametrize("tier", ["mesh", "hbm"])
def test_fused_batch_detect(tier):
    """A fused batch meets once: one claim a slot (hbm) or a group
    (mesh) still catches the flip, convicts rank 1 and retries the
    whole batch — the same bytes in both packages."""
    ref_run, port_run = RUNS[tier]
    want = [np.full(16, 10, np.float32).tobytes(),
            np.full(4, 40, np.int32).tobytes(),
            np.full(8, 5, np.int32).tobytes()]
    for run, plane in ((ref_run, ref_ig), (port_run, ig)):
        with armed(INJECT):
            assert all(r == want for r in run(4, _fused))
            assert _convicted(plane) == [1]


FUSED_SIGS = [
    (("allreduce", (16,), np.float32, "MPI_SUM"),
     ("allreduce", (4,), np.int32, "MPI_MAX"),
     ("bcast", (8,), np.int32, 1)),
    (("allreduce", (3,), np.float64, "MPI_MIN"),
     ("bcast", (2,), np.uint8, 0)),
    (("allreduce", (4,), np.float32, "MPI_PROD"),),
    (("bcast", (4,), np.bool_, 0),),
]


@pytest.mark.parametrize("sig", FUSED_SIGS, ids=range(len(FUSED_SIGS)))
def test_fused_ck_matches_reference(sig):
    """The batch's check spec, entry for entry the reference's, in hbm
    mode and (for batches of native reducers, the only ones the
    reference's mesh groups check) in mesh mode."""
    port_sig = tuple((k, s, convert.torch_dtype(d), e) for k, s, d, e in sig)
    ref_sig = tuple((k, s, np.dtype(d), e) for k, s, d, e in sig)
    assert port_fusion._fused_ck("hbm", port_sig) \
        == ref_fusion._fused_ck("hbm", ref_sig)
    assert port_fusion._fused_ck("tpu", port_sig) \
        == ref_fusion._fused_ck("mesh", ref_sig)


def _clean_mix(comm, put, op):
    r, size = comm.rank, comm.size
    comm.allreduce_arr(put(np.full(1024, 0.1 * (r + 1), np.float32)),
                       op.SUM)
    comm.allreduce_arr(put(np.full(16, r, np.int32)), op.MIN)
    comm.bcast_arr(put(np.arange(32, dtype=np.float32)), root=0)
    comm.allgather_arr(put(np.full(4, r + 1, np.float32)))
    qs = [comm.iallreduce_arr(put(np.full(8, r, np.float32)), op.SUM),
          comm.ibcast_arr(put(np.full(4, 3, np.int32)), 1 % size)]
    for q in qs:
        q.wait()
    return True


@pytest.mark.parametrize("tier", ["mesh", "hbm"])
def test_clean_run_zero_false_positives(tier):
    """Armed at 1-in-1 with no fault: the op mix (float sums in the
    reassociation band included) banks checks without a mismatch; the
    port's float16 SUM is checked too, and a bfloat16 op is not."""
    ref_run, port_run = RUNS[tier]

    def port_extra(comm, put, op):
        _clean_mix(comm, put, op)
        comm.allreduce_arr(put(np.full(64, 0.25 * (comm.rank + 1),
                                       np.float16)), op.SUM)
        before = _pv(port_registry, "integrity_checks")
        comm.allreduce_arr(put(np.full(64, comm.rank,
                                       ml_dtypes.bfloat16)), op.SUM)
        return before

    for run, reg, plane, fn in ((ref_run, ref_registry, ref_ig, _clean_mix),
                                (port_run, port_registry, ig, port_extra)):
        with armed(ARM):
            k0, m0 = (_pv(reg, "integrity_checks"),
                      _pv(reg, "integrity_mismatches"))
            run(4, fn)
            assert _pv(reg, "integrity_checks") > k0
            assert _pv(reg, "integrity_mismatches") == m0
            assert plane.convicted_snapshot() == []
    with armed(ARM):
        k0 = _pv(port_registry, "integrity_checks")
        port_run(4, port_extra)
        # the mix meets 5 times (its two nonblocking ops as one fused
        # batch), the float16 op once, the bfloat16 op unchecked: 4
        # ranks each
        assert _pv(port_registry, "integrity_checks") - k0 == 6 * 4


# -- the executing rank, fail-open, the injector, the flip --------------------

def _shards(values):
    ck = ("allreduce", ig.F_INTSUM, 4)
    return ck, [ig._Checked(v, v.clone(), ig._claim(ck, v), r)
                for r, v in enumerate(values)]


def test_bisect_convicts_executing_rank_on_compute_corruption():
    """Every deposit still matches its claim, but the reduction came
    out wrong: the executing rank is convicted, and the op retried."""
    comm = types.SimpleNamespace(rank=2, cid=0, group=[0, 1, 2, 3])
    ck, shards = _shards([torch.full((4,), r + 1, dtype=torch.int32)
                          for r in range(4)])

    def bad_fn(parts):
        out = torch.stack(parts).sum(0, dtype=torch.int32)
        out[0] += 1  # the "chip" mis-computes the reduction
        return [out]

    with armed(ARM):
        base = _pv(port_registry, "integrity_retry_ops")
        ig._run_checked(comm, bad_fn, ck, shards)
        recs = ig.convicted_snapshot()
        assert [(r["rank"], r["kind"]) for r in recs] == [(2, "allreduce")]
        assert _pv(port_registry, "integrity_retry_ops") == base + 1


def test_checker_defect_fails_open(monkeypatch):
    """A defect in the comparison never takes down the datapath: the
    op passes through untouched (the reference's claims that cannot be
    compared; here a comparison that raises)."""
    comm = types.SimpleNamespace(rank=0, cid=0, group=[0, 1])
    a = np.full(4, 1, np.int32)
    ref_shards = [ref_ig._Checked(a, a.copy(), object(), r) for r in (0, 1)]
    out = ref_ig._run_checked(comm, lambda p: [np.asarray(p[0]) * 2],
                              ("allreduce", ref_ig.F_INTSUM, 4), ref_shards)
    assert np.array_equal(out[0], a * 2)

    def broken(*args):
        raise ValueError("checker defect")

    monkeypatch.setattr(ig, "_eq", broken)
    ck, shards = _shards([_t(a), _t(a)])
    out = ig._run_checked(comm, lambda p: [p[0] * 2], ck, shards)
    assert torch.equal(out[0], _t(a) * 2)
    assert ig.convicted_snapshot() == []


def test_divergence_kernel_error_is_not_failed_open(monkeypatch):
    """Pinned divergence: the reference fails open on any checker
    exception, its digest's included; in the port a digest kernel that
    cannot build or launch raises through the collective (the
    digests are computed outside the fail-open clause)."""
    comm = types.SimpleNamespace(rank=0, cid=0, group=[0, 1])
    a = np.full(4, 1, np.int32)
    ref_shards = [ref_ig._Checked(a, a.copy(), ref_ig.digest(a, 1), r)
                  for r in (0, 1)]
    ck, shards = _shards([_t(a), _t(a)])

    def launch_fails(*args, **kw):
        raise RuntimeError("digest launch failed: cudaError_t 98")

    monkeypatch.setattr(ref_ig, "digest", launch_fails)
    out = ref_ig._run_checked(comm, lambda p: [np.asarray(p[0]) * 2],
                              ("allreduce", 1, 4), ref_shards)
    assert np.array_equal(out[0], a * 2)
    monkeypatch.setattr(k11, "digest", launch_fails)
    with pytest.raises(RuntimeError, match="digest launch failed"):
        ig._run_checked(comm, lambda p: [p[0] * 2], ck, shards)


def test_divergence_source_and_claim_stay_on_the_device():
    """Pinned divergence: the reference's gate keeps a host numpy copy
    of the source and a Python claim; the port's are a clone and K11's
    result tensor on the deposit's own device (here a CPU "device"),
    so no operand crosses to the host before verify."""
    with armed(ARM):
        for plane, x in ((ref_ig, jnp.arange(8, dtype=jnp.float32)),
                         (ig, torch.arange(8, dtype=torch.float32))):
            comm = types.SimpleNamespace(rank=0)
            ck = plane.spec("allreduce", "MPI_SUM", x)
            c, _ = plane.gate(comm, x, lambda s: s, ck)
            if plane is ref_ig:
                assert isinstance(c.src, np.ndarray)
                assert isinstance(c.d, float)
            else:
                assert isinstance(c.src, torch.Tensor)
                assert c.src.device == x.device
                assert c.src.data_ptr() != x.data_ptr()
                assert isinstance(c.d, torch.Tensor)
                assert c.d.device == x.device and c.d.dtype == torch.int64
                assert ig._values(ck, c.src, c.d.tolist()) \
                    == ref_ig.digest(np.arange(8, dtype=np.float32), 2)


@pytest.mark.parametrize("after,period", [(3, 2), (2, 0), (1, 1), (0.5, 0)])
def test_sdc_injector_sequence_matches_reference(after, period):
    seqs = []
    for fi in (ref_fi, port_fi):
        inj = fi.SdcInjector(1, after, period)
        seqs.append(([inj.should_flip() for _ in range(24)], inj.flips))
        assert inj.flips == 0 or inj.last_flip_ns > 0
    assert seqs[0] == seqs[1]
    if (after, period) == (3, 2):
        assert seqs[1][0][:12] == [False, False, True, False, True, False,
                                   True, False, True, False, True, False]


def test_sdc_injector_passive_without_plan():
    assert port_fi.sdc_injector(0, 4) is None
    assert port_fi.coll_injector(0) is None
    assert port_fi.rma_injector(0) is None


def test_flip_targets_checked_carrier():
    """The flip retargets only the carrier's datapath binding: the
    source and the claim stay pristine (what bisection attributes).
    An unwrapped value flips a copy — the caller's tensor is never
    written — with the reference's bytes; a fused deposit flips its
    first tensor, a mesh segment pair its operand, never its output."""
    a = np.full(9, 1.0, np.float32)
    x = _t(a)
    ck = ("allreduce", ig.F_FSUM, 4)
    c = ig._Checked(x, x.clone(), ig._claim(ck, x), 0)
    ig.flip_value(c)
    assert not torch.equal(c.v, x)
    assert torch.equal(c.src, _t(a)) and torch.equal(x, _t(a))
    assert ig._values(ck, c.src, c.d.tolist()) == ig.digest(c.src, ig.F_FSUM)
    raw = _t(np.full(5, 7, np.int32))
    flipped = ig.flip_value(raw)
    assert torch.equal(raw, _t(np.full(5, 7, np.int32)))
    assert _np(flipped).tobytes() \
        == ref_ig.flip_value(np.full(5, 7, np.int32)).tobytes()
    sig = (("allreduce", (4,), torch.int32, "MPI_SUM"),)
    ts = [_t(np.arange(4, dtype=np.int32)), _t(np.ones(3, np.int32))]
    f_sig, f_ts = ig.flip_value((sig, ts))
    assert f_sig is sig and f_ts[1] is ts[1]
    assert not torch.equal(f_ts[0], ts[0])
    op_, out = _t(np.ones(6, np.float32)), torch.zeros(6)
    f_op, f_out = ig.flip_value((op_, out))
    assert f_out is out and not torch.equal(f_op, op_)
