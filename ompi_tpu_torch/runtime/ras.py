"""RAS analog: resource allocation — turn user input into a node list.

Re-design of orte/mca/ras (node-list acquisition): sources are the
command line (--hosts a,b:4), a hostfile (--hostfile, the flex parser
ref: orte/util/hostfile/hostfile.c:51-55 collapsed to line parsing),
or the **simulator** (--simulate-nodes NxM — the ras/simulator analog,
ref: orte/mca/ras/simulator/ras_sim_module.c:67-91: fabricate an
N-node allocation with M slots each so multi-node mapping/launch/
wireup logic is testable on one machine; each simulated node's app
shell gives its ranks M devices of their own — M logical devices of
one card, M cards when the host has N × M, or M logical devices of the
CPU — a fake N-node × M-device mesh, tools/hostrun.py).

With no source the allocation is the single local node.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Node:
    """One allocated node (orte_node_t analog)."""

    name: str
    slots: int
    node_id: int = 0
    simulated: bool = False    # launched as a local process, fake identity
    local: bool = False        # the HNP's own host — exec directly, no agent
    sim_devices: int = 0       # simulator: the node's device count


def parse_hosts(spec: str) -> List[Node]:
    """--hosts a,b:4,c — OMPI's comma list with optional :slots."""
    nodes: List[Node] = []
    for i, item in enumerate(x for x in spec.split(",") if x.strip()):
        item = item.strip()
        if ":" in item:
            name, slots_s = item.rsplit(":", 1)
            slots = int(slots_s)
        else:
            name, slots = item, 1
        if slots < 1:
            raise ValueError(f"--hosts: bad slot count in {item!r}")
        nodes.append(Node(name=name, slots=slots, node_id=i,
                          local=name in ("localhost", "127.0.0.1")))
    if not nodes:
        raise ValueError("--hosts: empty host list")
    return nodes


def parse_hostfile(path: str) -> List[Node]:
    """Hostfile lines: ``name [slots=N]`` (# comments allowed)."""
    nodes: List[Node] = []
    with open(path) as f:
        for raw in f:
            line = raw.split("#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            name = parts[0]
            slots = 1
            for p in parts[1:]:
                m = re.fullmatch(r"slots=(\d+)", p)
                if m:
                    slots = int(m.group(1))
            nodes.append(Node(name=name, slots=slots,
                              node_id=len(nodes),
                              local=name in ("localhost", "127.0.0.1")))
    if not nodes:
        raise ValueError(f"hostfile {path}: no nodes")
    return nodes


def parse_simulate(spec: str) -> List[Node]:
    """--simulate-nodes NxM (N nodes, M slots/chips each) or just N."""
    m = re.fullmatch(r"(\d+)(?:x(\d+))?", spec.strip())
    if not m:
        raise ValueError(f"--simulate-nodes: expected NxM, got {spec!r}")
    n, slots = int(m.group(1)), int(m.group(2) or 1)
    if n < 1 or slots < 1:
        raise ValueError("--simulate-nodes: N and M must be >= 1")
    return [Node(name=f"sim{i}", slots=slots, node_id=i, simulated=True,
                 sim_devices=slots) for i in range(n)]


def allocate(hosts: Optional[str], hostfile: Optional[str],
             simulate: Optional[str], np: int) -> List[Node]:
    """Pick the allocation source (priority: simulate > hosts >
    hostfile > single local node sized to the job)."""
    given = sum(x is not None for x in (hosts, hostfile, simulate))
    if given > 1:
        raise ValueError(
            "--hosts, --hostfile and --simulate-nodes are exclusive")
    if simulate is not None:
        return parse_simulate(simulate)
    if hosts is not None:
        return parse_hosts(hosts)
    if hostfile is not None:
        return parse_hostfile(hostfile)
    return [Node(name="localhost", slots=np, node_id=0, local=True)]
