"""bml multiplexing and fail-over through the port
(ompi_tpu_torch/btl/base.py ``Endpoint``, btl/tcp's reconnect and its
``btl_tcp_rails`` striping), with the reference beside it.

The analogs of tests/test_bml.py's six tests.  The ``Endpoint`` cases
run through both packages (ids ``port`` and ``ref``) on the same fake
transports; the process jobs run the port's programs
(``ompi_tpu_torch/examples/sever_prog.py`` and ``rails_prog.py``, the
reference's ``tests/_sever_prog.py`` and ``_rails_prog.py``) through
the port's mpirun and hold their output to the reference test's.
"""

import os

import pytest

from ompi_tpu.btl import base as ref_base
from ompi_tpu_torch.btl import base as port_base
from ompi_tpu_torch.testing import mpirun_run

RAILS = os.path.join("ompi_tpu_torch", "examples", "rails_prog.py")
SEVER = os.path.join("ompi_tpu_torch", "examples", "sever_prog.py")


@pytest.fixture(params=["port", "ref"])
def base(request):
    return port_base if request.param == "port" else ref_base


class _FakeBtl:
    def __init__(self, base, name, exclusivity, fail_after=None):
        self.base = base
        self.name = name
        self.exclusivity = exclusivity
        self.fail_after = fail_after
        self.sent = []

    def send(self, peer, frag):
        if self.fail_after is not None \
                and len(self.sent) >= self.fail_after:
            raise self.base.BtlError(f"{self.name} died")
        self.sent.append(frag)


def test_endpoint_prefers_exclusivity_order(base):
    a = _FakeBtl(base, "fast", 100)
    b = _FakeBtl(base, "slow", 10)
    ep = base.Endpoint(3, [a, b])
    ep.send(("M", 1))
    assert a.sent and not b.sent
    assert ep.btl is a


def test_endpoint_fails_over_and_retries_the_frag(base):
    a = _FakeBtl(base, "dies", 100, fail_after=2)
    b = _FakeBtl(base, "backup", 10)
    ep = base.Endpoint(3, [a, b])
    for i in range(5):
        ep.send(("F", i))
    # first two frags on the primary, the failed third RETRIED on the
    # backup, all later traffic stays failed-over
    assert [f[1] for f in a.sent] == [0, 1]
    assert [f[1] for f in b.sent] == [2, 3, 4]
    assert ep.btl is b


def test_endpoint_exhausted_raises(base):
    a = _FakeBtl(base, "dies", 100, fail_after=0)
    ep = base.Endpoint(3, [a])
    with pytest.raises(base.BtlError):
        ep.send(("M",))


def test_tcp_severed_mid_rendezvous_recovers():
    """Sever the sender's tcp sockets between the RNDV head and the
    FRAG stream: the transport reconnects and resends its undrained
    frames; duplicate segments are absorbed by positioned writes."""
    r = mpirun_run(2, SEVER, mca=(("btl", "self,tcp"),),
                   timeout=150, job_timeout=90)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert b"sever ok" in r.stdout


def _rails_used(r) -> int:
    assert r.returncode == 0, r.stderr.decode()[-1500:]
    out = r.stdout.decode()
    line = [ln for ln in out.splitlines() if ln.startswith("rails used=")]
    assert line, out
    return int(line[0].split("=")[1].split()[0])


def test_multirail_striping_tcp():
    """bml/r2 multi-rail: with btl_tcp_rails=3, rendezvous FRAG
    segments round-robin across the rails (>= 2 rails carry frags) and
    the transfer is intact; the envelope stream stays ordered on rail
    0."""
    r = mpirun_run(2, RAILS,
                   mca=(("btl", "self,tcp"), ("btl_tcp_rails", "3"),
                        ("btl_tcp_max_send_size", "131072")),
                   timeout=200, job_timeout=150)
    assert _rails_used(r) >= 2


def test_single_rail_default_unchanged():
    r = mpirun_run(2, RAILS, mca=(("btl", "self,tcp"),),
                   timeout=200, job_timeout=150)
    assert _rails_used(r) == 1
