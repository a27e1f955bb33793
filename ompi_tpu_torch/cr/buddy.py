"""Buddy checkpointing: in-memory partner-replicated snapshots.

Port of the reference's cr/buddy.py: SCR-style multi-level C/R (Moody
et al., "Design, Modeling, and Evaluation of a Scalable Multi-level
Checkpointing System").  Each rank's checkpoint blob — the sharded
image of cr/shard.py (pickled residue + CRC-stamped array shards; a
card tensor's bytes copied device-to-host into a pinned stage) — is
serialized once and replicated over the wire to ``cr_buddy_degree``
partner ranks, who hold it in process memory
(``ProcState.extra["cr_buddy"]``).  Nothing touches a filesystem: the
copies live exactly where a respawned replacement can reach them over
MPI p2p, which is what makes kill -> respawn -> restore work without a
shared store.  The exchange is numpy over the host path (``Sendrecv``,
``Allreduce``), as in the reference; ``restore`` puts tensor leaves
back on the restoring rank's device.

Placement is a failure-domain-aware ring: copy k of rank r lives on
``(r + o_k) % size`` where the offsets ``o_k`` are chosen (from the
node_id each rank published into the modex at init) so that every
rank's partner lives on a DIFFERENT host whenever the job spans more
than one — a whole host dying then never takes a rank and all its
replicas together.  On a single host the offsets degrade to the
classic ring ``o_k = k`` (SCR partner placement).  A single failure
between two checkpoints is always recoverable with degree >= 1;
simultaneous loss of a rank AND all its partners is not (that is the
filesystem store's job — the two layers compose, ``cr.checkpoint``
for cold durability, buddy for fast in-job recovery).

Commit protocol (tolerates a rank dying mid-checkpoint): every rank
stores its own blob AND its partners' blobs *before* the barrier;
``committed`` advances only after.  At restore the target sequence is
``max(committed)`` over the group — if any rank committed S, every
rank reached the barrier for S, so every rank (including a dead one's
partner) stored S first.  The last ``KEEP_SEQS`` sequences are
retained so the pre-barrier window never discards the only restorable
snapshot.

API (collective over a full-world-size communicator, same contract as
``cr.quiesce``):

    buddy.checkpoint(comm, payload)   # -> seq, or -1 when degree == 0
    payload = buddy.restore(comm)     # -> None when nothing committed

Zero-cost-when-off: with ``cr_buddy_degree`` 0 (the default),
``checkpoint`` returns after a single int check — no quiesce, no
pickle, no traffic.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from ompi_tpu_torch import obs as _obs
from ompi_tpu_torch.cr import _keep_var as _cr_keep_var
from ompi_tpu_torch.cr import quiesce
from ompi_tpu_torch.cr import shard as _shard
from ompi_tpu_torch.mca.params import registry as _registry
from ompi_tpu_torch.op.op import MAX, MIN

_degree_var = _registry.register(
    "cr", "buddy", "degree", 0, int,
    help="In-memory buddy-checkpoint replicas per rank (SCR-style "
         "partner ring, offsets skipping same-host partners when the "
         "job spans multiple node_ids).  0 disables buddy "
         "replication entirely; 1 survives any single rank failure "
         "between checkpoints — including a whole-host failure when "
         "placement found an off-host offset")

_pv_ckpts = _registry.register_pvar(
    "cr", "buddy", "checkpoints",
    help="Buddy checkpoints committed by this rank")
_pv_bytes = _registry.register_pvar(
    "cr", "buddy", "bytes_replicated",
    help="Checkpoint bytes this rank shipped to partner ranks")
_pv_partner = _registry.register_pvar(
    "cr", "buddy", "partner_restores",
    help="Times this rank served a held partner copy to a restoring "
         "(typically respawned) rank")
_pv_crc_fallback = _registry.register_pvar(
    "cr", "buddy", "restore_crc_fallbacks",
    help="Buddy restores abandoned because a rank's replica failed "
         "its CRC (memory corruption in the in-memory tier): the "
         "whole world raises together")
_pv_us = _registry.register_pvar(
    "cr", "buddy", "replicate_us", var_class="highwatermark",
    help="Worst-case wall time of one buddy checkpoint (quiesce + "
         "pickle + ring exchange + commit barrier), microseconds")

# user tags must be >= 0; park buddy traffic far above anything an
# application plausibly uses (one tag pair per ring distance k, one
# pair for restore pulls)
_TAG_BASE = 998_000_000
_TAG_RESTORE = 998_500_000

# self + held sequences retained.  2, not 1: a rank can die after
# storing seq S but before committing it — survivors may then agree on
# S-1, which a keep-1 policy would already have dropped.
KEEP_SEQS = 2


def ring_offsets(nodes: Sequence[int], deg: int) -> List[int]:
    """Partner ring offsets for ``deg`` replicas given each comm
    rank's host (``nodes[r]`` = node_id of comm rank r).

    An offset ``o`` is *host-safe* when EVERY rank's partner at
    ``(r + o) % size`` lives on a different node — so one dead host
    can never hold both a rank's state and its replica.  Host-safe
    offsets are preferred in ascending order; if the topology yields
    fewer than ``deg`` of them (or the job is single-host), the
    remaining slots fall back to the smallest unused plain-ring
    offsets.  Every rank computes the same list from the same modex
    data, which is what keeps the Sendrecv pairing collective."""
    size = len(nodes)
    plain = list(range(1, min(deg, size - 1) + 1))
    if size < 2 or len(set(nodes)) < 2:
        return plain
    out = [o for o in range(1, size)
           if all(nodes[(r + o) % size] != nodes[r]
                  for r in range(size))][:deg]
    if len(out) < deg:
        for o in range(1, size):
            if o not in out:
                out.append(o)
                if len(out) == deg:
                    break
    return out[:deg]


def _rank_nodes(comm) -> List[int]:
    """node_id of every comm rank, from the modex (the value each
    rank published at init).  Missing keys (pre-modex bootstrap
    comms, stub RTEs) deterministically collapse to one host — every
    member reaches the same answer, never a split placement."""
    n = len(comm.group)
    rte = getattr(comm.state, "rte", None)
    if rte is None or not hasattr(rte, "modex_get"):
        return [0] * n
    nodes = [0] * n
    try:
        for i, g in enumerate(comm.group):
            nodes[i] = int(rte.modex_get(g, "node_id"))
    except (KeyError, LookupError, AttributeError, TypeError,
            ValueError):
        return [0] * n
    return nodes


def _buddy_state(state) -> Dict[str, Any]:
    """Per-rank replica store, private to this rank's ProcState (NOT
    world-shared: partners hold copies the way a remote node's RAM
    would, so a thread-world test exercises the same reachability a
    process job has)."""
    bs = state.extra.get("cr_buddy")
    if bs is None:
        bs = {
            "self": {},       # seq -> my pickled blob
            "held": {},       # (owner comm-rank, seq) -> their blob
            "committed": -1,  # newest barrier-committed seq
        }
        state.extra["cr_buddy"] = bs
    return bs


def committed_seq(state) -> int:
    """Newest committed sequence on this rank (-1 = none)."""
    return _buddy_state(state)["committed"]


def _keep_seqs() -> int:
    """Sequences retained per rank: the job-wide ``cr_keep`` knob,
    floored at KEEP_SEQS so the pre-barrier commit window can never
    discard the only restorable snapshot (the same knob prunes the
    filesystem tier's epoch directories — one retention policy across
    tiers).  cr_keep 0 means keep-all there, but buddy copies live in
    partner RAM, so the KEEP_SEQS default applies instead."""
    k = int(_cr_keep_var.value)
    return max(KEEP_SEQS, k) if k > 0 else KEEP_SEQS


def _prune(bs: Dict[str, Any], seq: int) -> None:
    floor = seq - _keep_seqs()  # keep (seq, seq-1, ...)
    for s in [s for s in bs["self"] if s <= floor]:
        del bs["self"][s]
    for k in [k for k in bs["held"] if k[1] <= floor]:
        del bs["held"][k]


def checkpoint(comm, payload: Any, degree: Optional[int] = None) -> int:
    """Collective in-memory snapshot; returns the committed sequence
    number, or -1 when buddy replication is off.  ``degree`` overrides
    the ``cr_buddy_degree`` MCA default for this call."""
    deg = int(_degree_var.value) if degree is None else int(degree)
    if deg <= 0:
        return -1  # zero-cost-when-off: one int check, nothing else
    state = comm.state
    if len(comm.group) != state.size:
        raise ValueError(
            "buddy.checkpoint must run on a full-world-size "
            "communicator (partner placement is defined over the "
            "whole job, like cr.quiesce)")
    size = comm.size
    deg = min(deg, size - 1)
    if deg <= 0:
        return -1
    quiesce(comm)
    # quiesce stays interruptible; the capture/replicate/commit phases
    # must not be torn by an armed ft interrupt (same discipline as
    # cr.checkpoint)
    with state.progress.deferred_interrupts():
        t0 = time.perf_counter()
        bs = _buddy_state(state)
        # agree on the sequence number: a replacement rank that was
        # re-seeded from the filesystem tier (or joined before its
        # first restore) has a stale local counter — max(committed)+1
        # keeps the ring's blob keys aligned on every rank
        me = np.array([bs["committed"]], dtype=np.int64)
        mx = np.empty(1, dtype=np.int64)
        comm.Allreduce(me, mx, MAX)
        seq = int(mx[0]) + 1
        # the exact shard image the filesystem tier writes (residue +
        # CRC-stamped shards), not a second ad-hoc whole-state pickle
        blob = _shard.dumps(payload)
        mine = np.frombuffer(blob, dtype=np.uint8)
        nbytes = np.array([len(blob)], dtype=np.int64)
        peer_n = np.zeros(1, dtype=np.int64)
        # failure-domain-aware placement: offsets chosen so partners
        # sit on a different host whenever the job spans more than one
        offs = ring_offsets(_rank_nodes(comm), deg)
        for k, o in enumerate(offs, start=1):
            dst = (comm.rank + o) % size
            src = (comm.rank - o) % size
            comm.Sendrecv(nbytes, dst, _TAG_BASE + 2 * k,
                          peer_n, src, _TAG_BASE + 2 * k)
            rbuf = np.empty(int(peer_n[0]), dtype=np.uint8)
            comm.Sendrecv(mine, dst, _TAG_BASE + 2 * k + 1,
                          rbuf, src, _TAG_BASE + 2 * k + 1)
            bs["held"][(src, seq)] = rbuf.tobytes()
            _pv_bytes.add(len(blob))
        bs["self"][seq] = blob
        _prune(bs, seq)
        # every rank stored seq (own + held copies) before anyone
        # commits: max(committed) at restore is therefore always a
        # sequence every surviving partner still holds
        comm.Barrier()
        bs["committed"] = seq
        _pv_ckpts.add(1)
        _pv_us.update_max((time.perf_counter() - t0) * 1e6)
    return seq


def restore(comm) -> Optional[Any]:
    """Collective restore from the newest committed buddy snapshot.
    Ranks missing their own copy (a respawned replacement) pull it
    from the lowest-distance surviving partner; every rank then rolls
    back to the same sequence.  Returns the payload, or None when no
    sequence has ever committed."""
    state = comm.state
    if len(comm.group) != state.size:
        raise ValueError(
            "buddy.restore must run on a full-world-size communicator")
    size = comm.size
    bs = _buddy_state(state)
    me = np.array([max(bs["self"], default=-1), bs["committed"]],
                  dtype=np.int64)
    table = np.empty((size, 2), dtype=np.int64)
    comm.Allgather(me, table)
    restore_seq = int(table[:, 1].max())
    if restore_seq < 0:
        comm.Barrier()
        return None
    missing = {r for r in range(size) if table[r, 0] < restore_seq}
    # who holds whose copy at restore_seq (the degree at checkpoint
    # time is not assumed — a copy either survived or it didn't)
    holds = np.zeros(size, dtype=np.uint8)
    for r in range(size):
        if r == comm.rank:
            holds[r] = 1 if restore_seq in bs["self"] else 0
        elif (r, restore_seq) in bs["held"]:
            holds[r] = 1
    htab = np.empty((size, size), dtype=np.uint8)
    comm.Allgather(holds, htab)
    for m in sorted(missing):
        supplier = None
        for k in range(1, size):
            s = (m + k) % size
            if s not in missing and htab[s][m]:
                supplier = s
                break
        if supplier is None:
            raise RuntimeError(
                f"buddy restore: no surviving replica of rank {m}'s "
                f"checkpoint seq {restore_seq} — every partner holding "
                f"it is gone (raise cr_buddy_degree, or checkpoint "
                f"again between failures)")
        if comm.rank == supplier:
            blob = bs["held"][(m, restore_seq)]
            n = np.array([len(blob)], dtype=np.int64)
            comm.Send(n, m, _TAG_RESTORE)
            comm.Send(np.frombuffer(blob, dtype=np.uint8),
                      m, _TAG_RESTORE + 1)
            _pv_partner.add(1)
        elif comm.rank == m:
            n = np.zeros(1, dtype=np.int64)
            comm.Recv(n, supplier, _TAG_RESTORE)
            rbuf = np.empty(int(n[0]), dtype=np.uint8)
            comm.Recv(rbuf, supplier, _TAG_RESTORE + 1)
            bs["self"][restore_seq] = rbuf.tobytes()
    # CRC-verify before trusting the in-memory replica (a corrupting
    # host flips bits in parked blobs too).  The verdict is AGREED — a
    # single corrupt rank makes the whole world raise together, never
    # a world split across checkpoint sequences.
    try:
        out = _shard.loads(bs["self"][restore_seq], state.device)
        ok = 1
    except Exception:
        # shard CRC mismatch (ValueError), or a decode blown up on
        # corrupt metadata the per-shard CRCs don't cover — either
        # way the replica is untrustworthy
        out = None
        ok = 0
    good = np.array([ok], dtype=np.int64)
    tot = np.empty(1, dtype=np.int64)
    comm.Allreduce(good, tot, MIN)
    if int(tot[0]) == 0:
        if comm.rank == 0:
            _pv_crc_fallback.add(1)
        _obs.record_event(_obs.EV_CKPT_CRC_FALLBACK,
                          restore_seq, rank=comm.rank)
        raise RuntimeError(
            f"buddy restore: replica CRC mismatch at seq "
            f"{restore_seq} (in-memory tier corrupt) — restore from "
            f"a filesystem checkpoint instead")
    bs["committed"] = restore_seq
    comm.Barrier()
    return out
