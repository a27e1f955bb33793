"""NIC enumeration + pairwise connectivity scoring — the opal if/
reachable analog.

Re-design of opal/mca/if (interface discovery) and
opal/mca/reachable/weighted (ref:
opal/mca/reachable/weighted/reachable_weighted.c — weighted scoring
of (local NIC, remote NIC) pairs: same network > same address kind >
different kind, scaled by link bandwidth).  Interfaces come from
sysfs + SIOCGIFADDR ioctls (Linux stdlib only); the tcp btl uses
``best_addr``/``score_pair`` to advertise every usable address in the
modex and to pick the highest-scoring reachable pair when dialing.
"""

from __future__ import annotations

import fcntl
import glob
import ipaddress
import os
import socket
import struct
from typing import Dict, List, Optional, Tuple

SIOCGIFADDR = 0x8915
SIOCGIFNETMASK = 0x891B


class Interface:
    __slots__ = ("name", "ip", "netmask", "up", "speed_mbps", "mtu",
                 "loopback")

    def __init__(self, name: str, ip: str, netmask: str, up: bool,
                 speed_mbps: int, mtu: int) -> None:
        self.name = name
        self.ip = ip
        self.netmask = netmask
        self.up = up
        self.speed_mbps = speed_mbps
        self.mtu = mtu
        self.loopback = ip.startswith("127.")

    @property
    def network(self) -> Optional[ipaddress.IPv4Network]:
        try:
            return ipaddress.IPv4Network(f"{self.ip}/{self.netmask}",
                                         strict=False)
        except ValueError:
            return None

    def __repr__(self) -> str:
        return (f"Interface({self.name}, {self.ip}/{self.netmask}, "
                f"up={self.up}, {self.speed_mbps} Mb/s)")


def _if_ioctl(sock: socket.socket, name: str, req: int) -> Optional[str]:
    try:
        packed = struct.pack("256s", name.encode()[:15])
        out = fcntl.ioctl(sock.fileno(), req, packed)
        return socket.inet_ntoa(out[20:24])
    except OSError:
        return None


def interfaces() -> List[Interface]:
    """Enumerate IPv4-configured NICs (the opal_if list analog)."""
    out: List[Interface] = []
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        for path in sorted(glob.glob("/sys/class/net/*")):
            name = os.path.basename(path)
            ip = _if_ioctl(s, name, SIOCGIFADDR)
            if ip is None:
                continue
            mask = _if_ioctl(s, name, SIOCGIFNETMASK) or "255.255.255.255"
            up = True
            try:
                with open(os.path.join(path, "operstate")) as fh:
                    st = fh.read().strip()
                up = st in ("up", "unknown")  # lo reports 'unknown'
            except OSError:
                pass
            speed = -1
            try:
                with open(os.path.join(path, "speed")) as fh:
                    speed = int(fh.read().strip())
            except (OSError, ValueError):
                pass
            mtu = 1500
            try:
                with open(os.path.join(path, "mtu")) as fh:
                    mtu = int(fh.read().strip())
            except (OSError, ValueError):
                pass
            out.append(Interface(name, ip, mask, up, speed, mtu))
    finally:
        s.close()
    if not out:
        out = [Interface("lo", "127.0.0.1", "255.0.0.0", True, -1,
                         65536)]
    return out


def _kind(ip: str) -> str:
    a = ipaddress.IPv4Address(ip)
    if a.is_loopback:
        return "loopback"
    if a.is_private:
        return "private"
    return "public"


def score_pair(local: Interface, remote_ip: str) -> int:
    """Weighted connectivity estimate for (local NIC, remote addr) —
    the reachable_weighted calculate_weight model: same network
    beats same kind beats mismatch, bandwidth breaks ties."""
    if not local.up:
        return 0
    lk, rk = _kind(local.ip), _kind(remote_ip)
    if lk == "loopback" or rk == "loopback":
        # loopback never reaches another host; same-host reachability
        # is handled by pick_remote_addr's explicit fallback so a
        # peer's advertised 127.0.0.1 can never outscore its real NIC
        return 0
    net = local.network
    if net is not None and ipaddress.IPv4Address(remote_ip) in net:
        base = 3000
    elif lk == rk:
        base = 2000
    else:
        base = 1000
    bw = max(0, min(local.speed_mbps, 400_000)) // 1000  # 0..400
    return base + bw


def advertised_addrs() -> List[str]:
    """Every usable local address, best NICs first — what the tcp btl
    publishes in the modex (multi-NIC hosts expose them all; the
    dialing side scores and picks)."""
    ifs = sorted(interfaces(),
                 key=lambda i: (not i.up, i.loopback, -i.speed_mbps))
    # loopback is never advertised: a cross-host dialer that selected
    # it would connect to its OWN host (same-host jobs use the
    # loopback-only if_ip path, not multi-NIC advertising)
    return [i.ip for i in ifs if i.up and not i.loopback]


def best_local_toward(remote_ip: str) -> Tuple[Optional[Interface], int]:
    """Highest-scoring local NIC for a remote address."""
    best, best_s = None, 0
    for i in interfaces():
        s = score_pair(i, remote_ip)
        if s > best_s:
            best, best_s = i, s
    return best, best_s


def pick_remote_addr(remote_ips: List[str]) -> Optional[str]:
    """Best remote address to dial from this host (max over the
    pairwise score matrix — the reachable bipartite-graph pick)."""
    best_ip, best_s = None, -1
    for rip in remote_ips:
        _, s = best_local_toward(rip)
        # a loopback address is always locally reachable (same host)
        if s == 0 and _kind(rip) == "loopback":
            s = 1
        if s > best_s:
            best_ip, best_s = rip, s
    return best_ip
