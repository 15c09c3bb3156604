"""The port's serving layer (``yolo_continuous_tpu_torch/serve.py``) on the CPU.

The nine tests of ``tests/test_serve.py`` on the port's ``Detector``
(``device="cpu"``), the port server's ``/detect`` JSON against the JAX
server's on the same JPEG and weights, one test for each serving fault of
the JAX package that the port fixes (a raising reload, the lock held over a
checkpoint read, unbounded client priorities, unframed ``/detect`` bodies),
and the watcher picking up the port trainer's ``.train.pt``. The priority
test waits until the recorder is entered, not until the queue is empty.
"""
import http.client
import json
import os
import socket
import struct
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_port import ANCHORS, lively, min_score_gap
from yolo_continuous_tpu.config.plan import TrainPlan as JaxPlan
from yolo_continuous_tpu.detect_api import Detector as JaxDetector
from yolo_continuous_tpu.serve import make_server as jax_make_server
from yolo_continuous_tpu_torch import serve as serve_mod
from yolo_continuous_tpu_torch.config.plan import TrainPlan
from yolo_continuous_tpu_torch.detect_api import Detector
from yolo_continuous_tpu_torch.nn.builder import YoloModel
from yolo_continuous_tpu_torch.ops.decode import decode_outputs
from yolo_continuous_tpu_torch.serve import (PRIORITIES, BatchingEngine, make_multi_server,
                                             make_server)
from yolo_continuous_tpu_torch.tools.jax_weights import state_dict_from_jax
from yolo_continuous_tpu_torch.train.checkpoint import save_checkpoint, train_checkpoint_path
from yolo_continuous_tpu_torch.train.ema import ModelEMA

cv2 = pytest.importorskip("cv2")


def _plan_cfg(save_dir="/tmp/"):
    """tests/test_serve.py's tiny net and plan."""
    net = {"depth_multiple": 1.0, "width_multiple": 1.0,
           "backbone": [[-1, 1, "Conv", [8, 3, 2]], [-1, 1, "Conv", [16, 3, 2]],
                        [-1, 1, "Conv", [16, 3, 2]], [-1, 1, "Conv", [32, 3, 2]],
                        [-1, 1, "Conv", [64, 3, 2]]],
           "head": [[[2, 3, 4], 1, "Detect", ["nc", "anchors"]]]}
    return {"device": "cpu", "train": "x", "val": "x", "epochs": 1, "batch_size": 2,
            "image_size": 64, "image_chan": 3, "enhance": True, "shuffle": True,
            "pin_memory": False, "drop_last": False, "workers": 0, "labels": ["a", "b"],
            "enhance_cfg": "cfg/enhance/enhance.yaml", "model_cfg": net, "anchors": ANCHORS,
            "anchors_mask": [[6, 7, 8], [3, 4, 5], [0, 1, 2]], "adam": True, "decay": "Cosine",
            "lrI": 0.001, "lrF": 0.1, "momentum": 0.9, "weight_decay": 0.0, "warmup": False,
            "warmup_epochs": 1, "warmup_max_iter": 1, "warmup_momentum": 0.8,
            "warmup_bias_lr": 0.1, "focal_gamma": 1.5, "focal_alpha": 0.25, "resume": False,
            "save_dir": save_dir, "save_name": "serve_t", "max_boxes": 8}


def _tiny_plan(save_path="/nonexistent/x.msgpack"):
    plan = TrainPlan(_plan_cfg())
    plan.save_path = save_path
    return plan


def _detector(plan, seed=0):
    return Detector(plan, device="cpu", seed=seed)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    p = s.getsockname()[1]
    s.close()
    return p


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv.server_address[1]


def _close(srv):
    srv.shutdown()
    srv.server_close()
    for e in srv.engines.values():
        e.close()


def _jpeg(shade=120, size=(48, 80)):
    img = np.full((*size, 3), shade, np.uint8)
    cv2.rectangle(img, (10, 10), (40, 35), (230, 40, 40), -1)
    ok, enc = cv2.imencode(".jpg", img)
    assert ok
    return enc.tobytes()


def _post(port, path, data=b"", timeout=120):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=30) as r:
        return json.loads(r.read())


def _scaled_pth(det, path, gain):
    """A ``.pth`` of ``det``'s weights with every conv weight times ``gain``."""
    sd = {k: (v * gain if k.endswith("conv.weight") else v).clone()
          for k, v in det.model.state_dict().items()}
    torch.save(sd, path)
    return sd


# ---------------------------------------------------------------- tests/test_serve.py's nine

def test_serve_http_roundtrip():
    plan = _tiny_plan()
    srv = make_server(plan, port=_free_port(), batch_size=4, max_wait_ms=20.0, conf=0.0,
                      nms=0.5, detector=_detector(plan))
    port = _serve(srv)
    try:
        health = _get(port, "/healthz")
        assert health["ok"] and health["batch"] == 4
        enc, results = _jpeg(), []

        def post():
            results.append(_post(port, "/detect", enc)[1])

        threads = [threading.Thread(target=post) for _ in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=180)
        assert len(results) == 3
        for res in results:
            assert set(res) == {"boxes", "scores", "classes", "labels"}
            assert len(res["boxes"]) == len(res["scores"]) == len(res["classes"]) \
                == len(res["labels"])
            assert all(len(b) == 4 for b in res["boxes"])
        assert results[0] == results[1] == results[2]
    finally:
        _close(srv)


class _FlakyDetector:
    """Delegates to a real Detector but raises on the first calls."""

    def __init__(self, det, fail_first=1):
        self._det, self.plan, self.calls, self._fail_first = det, det.plan, 0, fail_first

    def __call__(self, *a, **k):
        self.calls += 1
        if self.calls <= self._fail_first:
            raise RuntimeError("injected batch failure")
        return self._det(*a, **k)


def test_serve_batch_failure_isolated():
    plan = _tiny_plan()
    srv = make_server(plan, port=_free_port(), batch_size=2, max_wait_ms=5.0, conf=0.0,
                      nms=0.5, detector=_FlakyDetector(_detector(plan)), warmup=False)
    port = _serve(srv)
    try:
        enc = _jpeg(90, (32, 32))
        code, body = _post(port, "/detect", enc)
        assert code == 500 and "injected batch failure" in body["error"]
        code, body = _post(port, "/detect", enc)
        assert code == 200 and set(body) == {"boxes", "scores", "classes", "labels"}
    finally:
        _close(srv)


def test_submit_timeout_returns_none():
    plan = _tiny_plan()
    real = _detector(plan)

    class _Stalling:
        def __init__(self):
            self.plan = real.plan

        def __call__(self, *a, **k):
            time.sleep(2.0)
            return real(*a, **k)

    eng = BatchingEngine(_Stalling(), batch_size=1, max_wait_ms=1.0, conf=0.0, nms=0.5,
                         submit_timeout=0.2, warmup=False)
    try:
        t0 = time.monotonic()
        assert eng.submit(np.full((16, 16, 3), 80, np.uint8)) is None
        assert time.monotonic() - t0 < 1.5
        assert eng.stats()["timeouts"] == 1
    finally:
        eng.close()


def test_serve_multi_model_stats_and_conf():
    plan_a, plan_b = _tiny_plan(), _tiny_plan()
    srv = make_multi_server({"a": (plan_a, _detector(plan_a)), "b": (plan_b, _detector(plan_b))},
                            port=_free_port(), batch_size=2, max_wait_ms=5.0, conf=0.0, nms=0.5)
    port = _serve(srv)
    try:
        assert set(_get(port, "/healthz")["models"]) == {"a", "b"}
        models = _get(port, "/models")
        assert models["a"]["labels"] == ["a", "b"] and models["b"]["image_size"] == 64
        enc = _jpeg()
        res_a = _post(port, "/detect/a", enc)[1]
        assert res_a == _post(port, "/detect", enc)[1]          # the default is "a"
        assert set(_post(port, "/detect/b", enc)[1]) == {"boxes", "scores", "classes", "labels"}
        assert res_a["scores"]
        cut = sorted(res_a["scores"])[len(res_a["scores"]) // 2]
        res_cut = _post(port, f"/detect/a?conf={cut}", enc)[1]
        assert len(res_cut["scores"]) < len(res_a["scores"])
        assert all(s >= cut for s in res_cut["scores"])
        code, body = _post(port, "/detect/nope", enc)
        assert code == 404 and set(body["models"]) == {"a", "b"}
        stats = _get(port, "/stats")
        assert stats["a"]["requests"] == 3 and stats["a"]["batches"] >= 1
        assert stats["a"]["latency_ms"]["p50"] > 0
        assert stats["b"]["requests"] == 1 and stats["a"]["timeouts"] == 0
    finally:
        _close(srv)


def test_priority_ordering():
    """Requests queued behind a busy worker drain high, normal, low. The
    test waits until the worker has entered the recorder with the first
    request (not until the queue looks empty, which races with the first
    request's enqueue)."""
    plan = _tiny_plan()
    real = _detector(plan)
    order, gate, entered = [], threading.Event(), threading.Event()

    class _Recorder:
        def __init__(self):
            self.plan = real.plan

        def __call__(self, imgs, *a, **k):
            entered.set()
            gate.wait(30)
            order.append(int(round(float(imgs[0].max()) * 255)))
            return real(imgs, *a, **k)

    eng = BatchingEngine(_Recorder(), batch_size=1, max_wait_ms=1.0, conf=0.0, nms=0.5,
                         warmup=False)
    try:
        def img(v):          # 64 x 64 is the model size: the letterbox is the identity
            return np.full((64, 64, 3), v, np.uint8)

        threads = [threading.Thread(target=eng.submit, args=(img(10),))]
        threads[0].start()
        assert entered.wait(30)                # the worker holds the first request
        for v, pri in [(40, PRIORITIES["low"]), (80, PRIORITIES["normal"]),
                       (120, PRIORITIES["high"])]:
            t = threading.Thread(target=eng.submit, args=(img(v),), kwargs={"priority": pri})
            t.start()
            threads.append(t)
        deadline = time.monotonic() + 10
        while eng._q.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert eng._q.qsize() == 3
        gate.set()
        for t in threads:
            t.join(timeout=60)
        assert order == [10, 120, 80, 40]
        assert eng.stats()["by_priority"] == {"low": 1, "normal": 2, "high": 1}
    finally:
        gate.set()
        eng.close()


def test_urgent_skips_fill_wait():
    plan = _tiny_plan()
    eng = BatchingEngine(_detector(plan), batch_size=4, max_wait_ms=1500.0, conf=0.0, nms=0.5)
    try:
        img = np.full((64, 64, 3), 90, np.uint8)
        t0 = time.monotonic()
        assert eng.submit(img, priority=PRIORITIES["urgent"]) is not None
        dt_urgent = time.monotonic() - t0
        t0 = time.monotonic()
        assert eng.submit(img) is not None
        dt_normal = time.monotonic() - t0
        assert dt_normal >= 1.2 and dt_urgent < 1.0
    finally:
        eng.close()


def test_model_hot_reload(tmp_path):
    """POST /models/<name>/reload: 404 while no checkpoint exists, then a
    reload of a ``.pth`` changes the detections for the same input."""
    plan = _tiny_plan(str(tmp_path / "reload.msgpack"))
    det = _detector(plan)
    srv = make_server(plan, port=_free_port(), batch_size=2, max_wait_ms=5.0, conf=0.0,
                      nms=0.5, detector=det)
    port = _serve(srv)
    try:
        enc = _jpeg()
        code, before = _post(port, "/detect", enc)
        assert code == 200 and before["scores"]
        code, body = _post(port, "/models/default/reload")
        assert code == 404 and body["reloaded"] is False
        code, body = _post(port, "/models/nope/reload")
        assert code == 404 and "unknown model" in body["error"]
        _scaled_pth(det, tmp_path / "reload.pth", 1.5)
        code, body = _post(port, "/models/default/reload")
        assert code == 200 and body["reloaded"] is True
        code, after = _post(port, "/detect", enc)
        assert code == 200 and after != before
        assert srv.engine.stats()["reloads"] == 1
    finally:
        _close(srv)


def test_auto_reload_watcher(tmp_path):
    plan = _tiny_plan(str(tmp_path / "watch.msgpack"))
    det = _detector(plan)
    before = det.model.model[0].conv.weight.detach().clone()
    eng = BatchingEngine(det, batch_size=1, max_wait_ms=1.0, conf=0.0, nms=0.5, warmup=False,
                         reload_every=0.1)
    try:
        time.sleep(0.4)                          # no file: the polls do nothing
        assert eng.stats()["reloads"] == 0
        _scaled_pth(det, tmp_path / "watch.pth", 2.0)
        deadline = time.monotonic() + 10
        while eng.stats()["reloads"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stats()["reloads"] >= 1
        torch.testing.assert_close(det.model.model[0].conv.weight, before * 2.0, rtol=0, atol=0)
    finally:
        eng.close()


def test_stream_endpoint():
    plan = _tiny_plan()
    srv = make_server(plan, port=_free_port(), batch_size=4, max_wait_ms=10.0, conf=0.0,
                      nms=0.5, detector=_detector(plan))
    port = _serve(srv)
    try:
        encs = [_jpeg(shade) for shade in (60, 130, 200)]
        body = b"".join(struct.pack(">I", len(e)) + e for e in encs)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/detect/stream", body=body)
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("Content-Type") == "application/x-ndjson"
        lines = [json.loads(x) for x in resp.read().decode().splitlines()]
        conn.close()
        assert lines[-1] == {"done": True, "frames": 3}
        results = lines[:-1]
        assert [r["frame"] for r in results] == [0, 1, 2]
        for i, enc in enumerate(encs):
            assert set(results[i]) == {"frame", "boxes", "scores", "classes", "labels"}
            assert {k: v for k, v in results[i].items() if k != "frame"} == \
                _post(port, "/detect", enc)[1]
        junk = b"\x00" * 32
        body = struct.pack(">I", len(junk)) + junk + struct.pack(">I", len(encs[0])) + encs[0]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        conn.request("POST", "/detect/stream", body=body)
        lines = [json.loads(x) for x in conn.getresponse().read().decode().splitlines()]
        conn.close()
        assert lines[0] == {"frame": 0, "error": "undecodable image"}
        assert lines[1]["frame"] == 1 and "boxes" in lines[1]
        assert lines[-1] == {"done": True, "frames": 2}
    finally:
        _close(srv)


# ---------------------------------------------------------------- against the JAX server

def test_detect_json_matches_jax_server():
    """The same JPEG and weights through both servers: boxes within 1e-3 px,
    scores within 1e-5, classes and labels equal. The candidates above the
    threshold score at least 1e-5 apart, so both rank the same rows."""
    cfg = _plan_cfg()
    jplan = JaxPlan(dict(cfg))
    jplan.save_path = "/nonexistent/x.msgpack"
    jax_det = JaxDetector(jplan, dtype=jnp.float32)
    rs = np.random.RandomState(4)
    params, stats = lively(jax_det.params, rs), lively(jax_det.batch_stats, rs)
    params["detect"] = {n: {k: v * 16.0 if k == "kernel" else v for k, v in c.items()}
                        for n, c in params["detect"].items()}       # spread the scores
    jax_det = JaxDetector(jplan, dtype=jnp.float32, params=params, batch_stats=stats)
    plan = _tiny_plan()
    det = Detector(plan, device="cpu", state_dict=state_dict_from_jax(jax_det.spec, params, stats))
    img = np.random.RandomState(0).randint(0, 255, (64, 96, 3)).astype(np.uint8)
    enc = cv2.imencode(".jpg", img)[1].tobytes()     # texture: no two cells alike
    rgb = cv2.cvtColor(cv2.imdecode(np.frombuffer(enc, np.uint8), cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    from yolo_continuous_tpu_torch.ops.preprocess import letterbox
    x = letterbox(rgb, (64, 64), (114, 114, 114))[0][None].astype(np.float32) / 255.0
    with torch.no_grad():
        pred = decode_outputs(det.forward(x), det.spec.anchors, det.spec.strides)
    score = (pred[..., 4] * pred[..., 5:].max(-1).values).numpy()
    above = score[score >= 0.4]
    assert 1 < above.size < 100 and min_score_gap(above[None], above.size - 1) > 1e-5

    kw = dict(batch_size=2, max_wait_ms=5.0, conf=0.4, nms=0.45)
    ours = make_server(plan, port=_free_port(), detector=det, **kw)
    ref = jax_make_server(jplan, port=_free_port(), detector=jax_det, **kw)
    try:
        got = _post(_serve(ours), "/detect", enc)[1]
        want = _post(_serve(ref), "/detect", enc)[1]
    finally:
        _close(ours)
        _close(ref)
    assert 0 < len(want["scores"]) < 100
    assert got["classes"] == want["classes"] and got["labels"] == want["labels"]
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-5)


# ---------------------------------------------------------------- the four fixed faults

def test_reload_error_is_counted_and_watcher_keeps_polling(tmp_path):
    """Fault 1: a checkpoint that fails to load neither kills the watcher nor
    gives the standard library's bare 500 on the reload endpoint."""
    plan = _tiny_plan(str(tmp_path / "bad.msgpack"))
    det = _detector(plan)
    (tmp_path / "bad.pth").write_bytes(b"not a checkpoint")
    srv = make_server(plan, port=_free_port(), batch_size=1, max_wait_ms=1.0, conf=0.0,
                      nms=0.5, detector=det, warmup=False, reload_every=0.1)
    port = _serve(srv)
    eng = srv.engine
    try:
        deadline = time.monotonic() + 10
        while eng.stats()["reload_errors"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stats()["reload_errors"] >= 1 and eng.stats()["reloads"] == 0
        code, body = _post(port, "/models/default/reload")
        assert code == 500 and body["reloaded"] is False and body["error"]
        assert eng.stats()["reload_errors"] >= 2
        time.sleep(0.01)
        sd = _scaled_pth(det, tmp_path / "bad.pth", 0.5)    # the trainer writes a good one
        deadline = time.monotonic() + 10
        while eng.stats()["reloads"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stats()["reloads"] >= 1               # the watcher survived
        torch.testing.assert_close(det.model.model[0].conv.weight, sd["model.0.conv.weight"],
                                   rtol=0, atol=0)
    finally:
        _close(srv)


def test_reload_reads_without_the_lock():
    """Fault 2: while a reload is blocked reading its checkpoint, a request
    is served; the lock is taken only for the swap."""
    plan = _tiny_plan()
    det = _detector(plan)
    reading, release = threading.Event(), threading.Event()
    served = {k: v.clone() for k, v in det.model.state_dict().items()}

    def slow_read(path=None, use_ema=True):
        reading.set()
        assert release.wait(30)
        return served

    det.read_weights = slow_read
    eng = BatchingEngine(det, batch_size=1, max_wait_ms=1.0, conf=0.0, nms=0.5)
    try:
        result = []
        t = threading.Thread(target=lambda: result.append(eng.reload()))
        t.start()
        assert reading.wait(30)
        t0 = time.monotonic()
        res = eng.submit(np.full((64, 64, 3), 90, np.uint8), timeout=20)
        assert res is not None and "boxes" in res and time.monotonic() - t0 < 20
        assert t.is_alive() and not result                # the reload is still reading
        release.set()
        t.join(30)
        assert result == [True] and eng.stats()["reloads"] == 1
    finally:
        release.set()
        eng.close()


def test_priorities_are_clamped():
    """Fault 3: integer priorities count in the four named levels; 999 is
    urgent (it dispatches at once), -50 is low."""
    assert serve_mod.clamp_priority(999) == PRIORITIES["urgent"]
    assert serve_mod.clamp_priority(-50) == PRIORITIES["low"]
    assert serve_mod.clamp_priority("1") == PRIORITIES["high"]
    plan = _tiny_plan()
    srv = make_server(plan, port=_free_port(), batch_size=4, max_wait_ms=1500.0, conf=0.0,
                      nms=0.5, detector=_detector(plan))
    port = _serve(srv)
    try:
        enc = _jpeg()
        t0 = time.monotonic()
        assert _post(port, "/detect?priority=999", enc)[0] == 200
        assert time.monotonic() - t0 < 1.0               # took the urgent path
        srv.engine.submit(np.full((64, 64, 3), 90, np.uint8), priority=-50)
        assert _post(port, "/detect?priority=x1", enc)[0] == 400
        assert srv.engine.stats()["by_priority"] == {"urgent": 1, "low": 1}
        assert set(srv.engine._n_by_priority) == {2, -1}
    finally:
        _close(srv)


def test_unframed_and_chunked_detect_bodies():
    """Fault 4: a chunked /detect body is read whole, and the next request on
    the same keep-alive connection is answered; a body with neither
    Content-Length nor chunking is answered and the connection closed, so
    its bytes never parse as a request."""
    plan = _tiny_plan()
    srv = make_server(plan, port=_free_port(), batch_size=2, max_wait_ms=5.0, conf=0.0,
                      nms=0.5, detector=_detector(plan))
    port = _serve(srv)
    try:
        enc = _jpeg()
        want = _post(port, "/detect", enc)[1]
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        chunks = (enc[i:i + 500] for i in range(0, len(enc), 500))
        conn.request("POST", "/detect", body=chunks, encode_chunked=True,
                     headers={"Transfer-Encoding": "chunked"})
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read()) == want
        conn.request("POST", "/detect", body=enc)          # same connection, Content-Length
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read()) == want
        conn.close()

        with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
            s.sendall(b"POST /detect HTTP/1.1\r\nHost: x\r\n\r\n" + enc)
            data = b""
            while True:
                part = s.recv(65536)
                if not part:
                    break                                 # the server closed the connection
                data += part
        assert data.startswith(b"HTTP/1.1 400") and data.count(b"HTTP/1.1") == 1
        assert _get(port, "/stats")["default"]["requests"] == 3
    finally:
        _close(srv)


def test_watcher_picks_up_a_train_checkpoint(tmp_path):
    """The watcher polls the file the Detector reads: here the port
    trainer's ``<stem>.train.pt``, whose EMA weights it serves."""
    plan = _tiny_plan(str(tmp_path / "live.msgpack"))
    det = _detector(plan)
    eng = BatchingEngine(det, batch_size=1, max_wait_ms=1.0, conf=0.0, nms=0.5, warmup=False,
                         reload_every=0.1)
    try:
        model = YoloModel(det.spec).init_weights(torch.Generator().manual_seed(7))
        state = {"model": model, "opt": torch.optim.SGD(model.parameters(), lr=0.1),
                 "ema": ModelEMA(model), "step": 3}
        path = train_checkpoint_path(plan.save_path)
        assert path.endswith(".train.pt") and eng.weights_path() is None
        save_checkpoint(path, state)
        assert eng.weights_path() == path
        deadline = time.monotonic() + 10
        while eng.stats()["reloads"] == 0 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert eng.stats()["reloads"] == 1
        for k, v in state["ema"].tree.items():
            torch.testing.assert_close(det.model.state_dict()[k], v, rtol=0, atol=0)
        assert os.path.exists(path)
    finally:
        eng.close()


def test_serve_cli_defaults_to_the_card(monkeypatch):
    """``python -m yolo_continuous_tpu_torch.serve`` serves on cuda by default
    (raising without a card) and on the CPU with ``--device cpu``."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serve_mod.main(["cfg/chip_tiny.yaml"])
    seen = {}

    def fake_server(models, *a, **kw):
        seen.update(models=models, device=kw["device"])

        class _Srv:
            def serve_forever(self):
                seen["served"] = True
        return _Srv()

    monkeypatch.setattr(serve_mod, "make_multi_server", fake_server)
    serve_mod.main(["cfg/chip_tiny.yaml", "--device", "cpu", "--model", "b=cfg/chip_tiny.yaml"])
    assert seen["served"] and seen["device"] == torch.device("cpu")
    assert list(seen["models"]) == ["default", "b"]
