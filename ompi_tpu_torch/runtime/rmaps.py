"""RMAPS analog: map ranks onto the allocated nodes.

Port of the reference's runtime/rmaps.py, a re-design of orte/mca/rmaps: the map is the launch blueprint shipped
to each node's daemon.  Policies:

  * ``byslot`` / ``bynode`` — round_robin component (ref:
    orte/mca/rmaps/round_robin): fill nodes to slot capacity vs
    round-robin across nodes;
  * ``ppr:N:node`` — procs-per-resource (ref: orte/mca/rmaps/ppr):
    exactly N ranks per node, node order;
  * ``seq`` — sequential mapper (ref: orte/mca/rmaps/seq): strict
    round-robin in allocation order, ignoring slot counts;
  * ``rankfile:PATH`` — explicit placement (ref:
    orte/mca/rmaps/rank_file): lines ``rank R=nodename`` (or
    ``R nodename``); every rank must be assigned exactly once.

Within-node placement (cores/NUMA — the mindist concern) is handled
by binding at rank bring-up (runtime/topology.py, --bind-to).

Two launch-unit shapes per node:

  * classic — one process per rank (blocks of nlocal=0 below);
  * hybrid  — rank-threads grouped into app shells of ``rpp`` ranks
    (ranks that meet on a device share one process; requires
    *contiguous* global ranks per shell, which is why non-contiguous
    mappings are rejected when rpp > 1).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

from .ras import Node


@dataclass
class ProcSpec:
    """One local launch unit on a node: a single rank process
    (nlocal == 0) or an app shell owning ranks
    [rank_base, rank_base + nlocal)."""

    rank_base: int
    nlocal: int  # 0 = classic single-rank process


@dataclass
class NodeMap:
    node: Node
    procs: List[ProcSpec] = field(default_factory=list)

    @property
    def ranks(self) -> List[int]:
        out: List[int] = []
        for p in self.procs:
            out += list(range(p.rank_base,
                              p.rank_base + max(1, p.nlocal)))
        return out


def map_ranks(nodes: List[Node], np: int, rpp: int = 1,
              policy: str = "byslot",
              oversubscribe: bool = False) -> List[NodeMap]:
    """Produce the job map.  ``rpp`` > 1 selects hybrid shells of that
    many rank-threads (capped per node by its slot count and the ranks
    assigned to it)."""
    total_slots = sum(n.slots for n in nodes)
    base_policy = policy.split(":", 1)[0]
    if base_policy not in ("byslot", "bynode", "ppr", "seq",
                           "rankfile"):
        raise ValueError(f"unknown mapping policy {policy!r}")
    if np > total_slots and not oversubscribe \
            and base_policy not in ("seq", "rankfile", "ppr"):
        raise ValueError(
            f"not enough slots: {np} ranks > {total_slots} slots "
            f"(use --oversubscribe)")
    if rpp > 1 and base_policy not in ("byslot", "ppr"):
        raise ValueError(
            "--ranks-per-proc > 1 requires a contiguous mapping "
            "(byslot or ppr: app shells own contiguous rank blocks)")

    # ranks → nodes
    per_node: List[List[int]] = [[] for _ in nodes]
    if base_policy == "ppr":
        # ppr:N:node — exactly N ranks per node in node order
        parts = policy.split(":")
        if len(parts) != 3 or parts[2] != "node":
            raise ValueError(
                f"ppr policy must be 'ppr:N:node', got {policy!r}")
        try:
            n_per = int(parts[1])
        except ValueError:
            raise ValueError(f"bad ppr count in {policy!r}") from None
        if n_per < 1:
            raise ValueError("ppr count must be >= 1")
        if np > n_per * len(nodes):
            raise ValueError(
                f"ppr:{n_per}:node places at most "
                f"{n_per * len(nodes)} ranks < {np}")
        over = [n.name for n in nodes if n_per > n.slots]
        if over and not oversubscribe:
            raise ValueError(
                f"ppr:{n_per}:node exceeds the slot count on "
                f"node(s) {over} (use --oversubscribe)")
        rank = 0
        for i in range(len(nodes)):
            take = min(n_per, np - rank)
            per_node[i] = list(range(rank, rank + take))
            rank += take
            if rank >= np:
                break
    elif base_policy == "seq":
        # strict round-robin in allocation order, slots ignored
        for rank in range(np):
            per_node[rank % len(nodes)].append(rank)
    elif base_policy == "rankfile":
        _, _, path = policy.partition(":")
        if not path:
            raise ValueError("rankfile policy needs a path "
                             "(rankfile:PATH)")
        by_name = {n.name: i for i, n in enumerate(nodes)}
        placed = {}
        with open(path) as fh:
            for ln, line in enumerate(fh, 1):
                line = line.split("#", 1)[0].strip()
                if not line:
                    continue
                # 'rank R=node' (reference syntax) or 'R node'
                try:
                    if line.startswith("rank") and "=" in line:
                        rpart, npart = line[4:].split("=", 1)
                        r, name = int(rpart.strip()), npart.split()[0]
                    else:
                        toks = line.split()
                        r, name = int(toks[0]), toks[1]
                except (ValueError, IndexError):
                    raise ValueError(
                        f"rankfile line {ln}: malformed entry "
                        f"{line!r}") from None
                if not 0 <= r < np:
                    raise ValueError(
                        f"rankfile line {ln}: rank {r} out of range "
                        f"for -np {np}")
                if name not in by_name:
                    raise ValueError(
                        f"rankfile line {ln}: unknown node {name!r}")
                if r in placed:
                    raise ValueError(
                        f"rankfile line {ln}: rank {r} placed twice")
                placed[r] = by_name[name]
        missing = [r for r in range(np) if r not in placed]
        if missing:
            raise ValueError(
                f"rankfile leaves rank(s) {missing} unplaced")
        counts: Dict[int, int] = {}
        for r in range(np):
            counts[placed[r]] = counts.get(placed[r], 0) + 1
        over = [nodes[i].name for i, c in counts.items()
                if c > nodes[i].slots]
        if over and not oversubscribe:
            raise ValueError(
                f"rankfile oversubscribes node(s) {over} "
                f"(use --oversubscribe)")
        for r in range(np):
            per_node[placed[r]].append(r)
    if base_policy == "byslot":
        # within capacity: fill each node to its slots in order.
        # oversubscribed: contiguous slot-proportional shares (largest-
        # remainder), preserving the per-node contiguity the hybrid
        # shells rely on.
        if np <= total_slots:
            shares = []
            left = np
            for n in nodes:
                take = min(n.slots, left)
                shares.append(take)
                left -= take
        else:
            shares = [np * n.slots // total_slots for n in nodes]
            rema = sorted(
                range(len(nodes)),
                key=lambda i: (-(np * nodes[i].slots % total_slots), i))
            for i in rema[:np - sum(shares)]:
                shares[i] += 1
        rank = 0
        for i, take in enumerate(shares):
            per_node[i] = list(range(rank, rank + take))
            rank += take
    elif base_policy == "bynode":  # round-robin
        i = 0
        counts = [0] * len(nodes)
        for rank in range(np):
            # next node with free slots, else plain round-robin when
            # oversubscribed
            tries = 0
            while tries < len(nodes) and counts[i] >= nodes[i].slots \
                    and any(c < n.slots for c, n in zip(counts, nodes)):
                i = (i + 1) % len(nodes)
                tries += 1
            per_node[i].append(rank)
            counts[i] += 1
            i = (i + 1) % len(nodes)

    # ranks → launch units
    maps: List[NodeMap] = []
    for node, ranks in zip(nodes, per_node):
        nm = NodeMap(node=node)
        if ranks:
            if rpp > 1:
                # contiguity invariant for HybridWorld
                if ranks != list(range(ranks[0], ranks[0] + len(ranks))):
                    raise ValueError(
                        "hybrid shells need contiguous ranks per node")
                base = ranks[0]
                left = len(ranks)
                while left > 0:
                    n = min(rpp, left)
                    nm.procs.append(ProcSpec(rank_base=base, nlocal=n))
                    base += n
                    left -= n
            else:
                nm.procs = [ProcSpec(rank_base=r, nlocal=0) for r in ranks]
        maps.append(nm)
    return maps
