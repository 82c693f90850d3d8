"""The port's HTTP server (``retto_tpu_torch.serve``, a copy of
``retto_tpu/serve.py``) with every case of tests/test_serve.py: a
FakeEngine session on an ephemeral port, the micro-batcher on its own, and
a server whose ``/ocr`` rides the fused ``DevicePipeline`` on the CPU (the
tiny float32 checkpoints of tests/torch_tiny_ckpt.py).  A COMPAT session
serves ``/ocr`` through the staged session."""

from __future__ import annotations

import io
import json
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
from PIL import Image

from retto_tpu_torch import (
    BucketConfig,
    DevicePipeline,
    FakeEngine,
    PipelineMode,
    RettoSession,
    SessionConfig,
)
from retto_tpu_torch.ops.charset import CharacterDict
from retto_tpu_torch.serve import MicroBatcher, make_server
from torch_tiny_ckpt import configs, write_tiny_checkpoints

CHARS = CharacterDict(["a", "b", "c"])


def start(srv):
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{srv.server_address[1]}"


def fake_session(mode=PipelineMode.PERFORMANCE):
    return RettoSession(SessionConfig(mode=mode),
                        engine=FakeEngine(rec_classes=CHARS.num_classes, device="cpu"),
                        charset=CHARS, device="cpu")


@pytest.fixture(scope="module")
def server():
    srv = make_server(fake_session(), "127.0.0.1", 0)
    yield start(srv)
    srv.shutdown()
    srv.server_close()


def png_bytes():
    arr = np.zeros((256, 320, 3), np.uint8)
    arr[60:90, 40:240] = 255
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return buf.getvalue()


def post(url, data, timeout=120):
    req = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.read()


def test_healthz(server):
    with urllib.request.urlopen(f"{server}/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"ok": True}


def test_ocr_endpoint(server):
    body = json.loads(post(f"{server}/ocr", png_bytes()))
    assert set(body) == {"det_result", "cls_result", "rec_result"}
    assert body["rec_result"][0]["text"] == "ab"


def test_ocr_stream_ndjson(server):
    lines = [json.loads(x) for x in post(f"{server}/ocr/stream", png_bytes()).splitlines()
             if x.strip()]
    assert [x["stage"] for x in lines] == ["det", "cls", "rec"]
    assert lines[2]["result"][0]["text"] == "ab"


def test_bad_image_422(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(f"{server}/ocr", b"not an image", timeout=30)
    assert ei.value.code == 422


def test_empty_body_400(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(f"{server}/ocr", b"", timeout=30)
    assert ei.value.code == 400


def test_unknown_path_404(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{server}/nope", timeout=30)
    assert ei.value.code == 404


def test_metrics_endpoint(server):
    with urllib.request.urlopen(f"{server}/metrics", timeout=30) as r:
        body = json.loads(r.read())
    assert "batches" in body and "images" in body and "session" in body


def test_concurrent_requests_micro_batch(server):
    payload = png_bytes()
    with ThreadPoolExecutor(8) as pool:
        results = list(pool.map(lambda _: json.loads(post(f"{server}/ocr", payload, 180)),
                                range(8)))
    assert all(r["rec_result"][0]["text"] == "ab" for r in results)


def test_microbatcher_gathers():
    calls = []

    class Runner:
        def run_many(self, datas):
            calls.append(len(datas))
            time.sleep(0.05)
            return [f"r{i}" for i in range(len(datas))]

        def run(self, d):
            return "single"

    b = MicroBatcher(Runner(), max_batch=8, max_wait_ms=40.0)
    futs = [b.submit(bytes([i])) for i in range(8)]
    assert len([f.result(timeout=5) for f in futs]) == 8
    b.stop()
    assert sum(calls) == 8
    assert len(calls) <= 3


def test_microbatcher_isolates_failures():
    class Runner:
        def run_many(self, datas):
            raise RuntimeError("batch boom")

        def run(self, d):
            if d == b"bad":
                raise ValueError("bad image")
            return "ok"

    b = MicroBatcher(Runner(), max_batch=4, max_wait_ms=30.0)
    f1, f2 = b.submit(b"good"), b.submit(b"bad")
    assert f1.result(timeout=5) == "ok"
    with pytest.raises(ValueError):
        f2.result(timeout=5)
    b.stop()


def test_microbatcher_stage_dispatch():
    class Runner:
        def run_many(self, datas, stage_callback=None):
            for i in range(len(datas)):
                if stage_callback:
                    stage_callback(i, ("det", i))
                    stage_callback(i, ("rec", i))
            return [f"r{i}" for i in range(len(datas))]

    b = MicroBatcher(Runner(), max_batch=4, max_wait_ms=50.0)
    assert b.supports_stages
    ev0, ev1 = [], []
    f0, f1 = b.submit(b"a", stage_cb=ev0.append), b.submit(b"b", stage_cb=ev1.append)
    assert f0.result(timeout=5) == "r0" and f1.result(timeout=5) == "r1"
    b.stop()
    assert ev0 == [("det", 0), ("rec", 0)]
    assert ev1 == [("det", 1), ("rec", 1)]


@pytest.fixture(scope="module")
def dp_server(tmp_path_factory):
    """/ocr rides the fused DevicePipeline (tiny checkpoints, CPU)."""
    weights = write_tiny_checkpoints(tmp_path_factory.mktemp("tiny_serve"))
    session = RettoSession(configs(SessionConfig, BucketConfig), weights=weights, device="cpu")
    srv = make_server(session, "127.0.0.1", 0, max_wait_ms=400.0)
    assert isinstance(srv.batcher.runner, DevicePipeline)
    assert srv.batcher.supports_stages
    yield start(srv), srv, session
    srv.shutdown()
    srv.server_close()
    session.close()


def test_stream_concurrent_clients_batched(dp_server):
    """Two concurrent /ocr/stream clients both get det, cls, rec from the
    micro-batched fused call; /ocr returns run_many's result."""
    url, srv, session = dp_server
    png = png_bytes()
    assert len(post(f"{url}/ocr/stream", png, 600).splitlines()) == 3  # warm
    batches_before = srv.batcher.batches
    results = [None, None]

    def client(k):
        results[k] = [json.loads(x) for x in post(f"{url}/ocr/stream", png, 600).splitlines()
                      if x.strip()]

    threads = [threading.Thread(target=client, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    for res in results:
        assert res is not None
        assert [x["stage"] for x in res] == ["det", "cls", "rec"]
    assert srv.batcher.batches - batches_before <= 2
    ref = session.device_pipeline().run_many([png])[0].to_dict()
    assert json.loads(post(f"{url}/ocr", png, 600)) == json.loads(json.dumps(ref))


def test_compat_session_serves_ocr_through_the_staged_path():
    session = fake_session(PipelineMode.COMPAT)
    srv = make_server(session, "127.0.0.1", 0)
    assert srv.batcher.runner is session
    url = start(srv)
    try:
        body = json.loads(post(f"{url}/ocr", png_bytes()))
        assert body == json.loads(session.run(png_bytes()).to_json())
    finally:
        srv.shutdown()
        srv.server_close()
