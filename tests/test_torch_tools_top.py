"""The pool's operator tools through the port (ompi_tpu_torch/tools/
top.py and tools/attach.py), with the reference beside them.

The analogs of tests/test_obs.py's ``test_attach_events_live_then_
persisted``, ``test_top_render_and_once`` and ``test_top_render_empty_
pool``, on the port's pool (``DVMServer`` on the CPU, the port's
``examples/dvm_session.py``).  ``top.render`` is a pure function of a
metrics document: the port's frame of the port pool's document is the
reference's ``render`` of the same document, character for character.
"""

import os

import pytest
import torch

from ompi_tpu.tools import top as ref_top
from ompi_tpu_torch.tools import attach, top, traceview
from ompi_tpu_torch.tools.dvm import DVMServer, DvmClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROG = os.path.join(REPO, "ompi_tpu_torch", "examples", "dvm_session.py")
T = 60  # seconds: every run RPC of this file


@pytest.fixture
def pool(tmp_path):
    uri = str(tmp_path / "dvm.uri")
    srv = DVMServer(8, devices=[torch.device("cpu")], uri_file=uri).start()
    yield srv, uri
    srv.stop()


def test_attach_events_live_then_persisted(pool, capsys):
    """attach --events: live over the metrics RPC while the pool
    answers; after halt, from the persisted <uri>.events.json ring,
    which merges onto traceview's timeline."""
    srv, uri = pool
    with DvmClient(uri) as c:
        sid = c.attach(2)["sid"]
        assert c.run(sid, PROG, ["ev"], timeout=T).get("code") == 0
        c.detach(sid)
    assert attach.main([uri, "--events"]) == 0
    out = capsys.readouterr().out
    assert "flight recorder (live)" in out
    assert "dvm_attach" in out and "dvm_run" in out

    with DvmClient(uri) as c:
        c.halt()
    srv.stop()
    persisted = f"{uri}.events.json"
    assert os.path.isfile(persisted)
    assert attach.main([uri, "--events", "8"]) == 0
    out = capsys.readouterr().out
    assert f"flight recorder ({persisted})" in out
    assert "dvm_halt" in out
    dumps = traceview.load_dumps([persisted])
    assert dumps[0]["flight"] and dumps[0]["rank"] == -1
    doc = traceview.chrome_trace(dumps, [])
    assert any(e.get("cat") == "flight" for e in doc["traceEvents"])


def test_top_render_and_once(pool, capsys):
    srv, uri = pool
    with DvmClient(uri) as c:
        sid = c.attach(2)["sid"]
        assert c.run(sid, PROG, ["top"], timeout=T).get("code") == 0
        m = c.metrics()
        frame = top.render(m)
        assert f"s{sid:>3}" in frame and "jobs" in frame
        assert "flight recorder" in frame
        assert frame == ref_top.render(m)
        assert top.main([uri, "--once"]) == 0
        out = capsys.readouterr().out
        assert "tpu-dvm pid" in out and "sessions" in out
        assert top.main([uri, "--prometheus"]) == 0
        out = capsys.readouterr().out
        assert "# TYPE" in out
        c.detach(sid)


def test_top_render_empty_pool():
    m = {"pid": 1, "capacity": 8, "active_ranks": 0, "sessions": {},
         "events": []}
    frame = top.render(m)
    assert "(no resident sessions)" in frame
    assert frame == ref_top.render(m)
