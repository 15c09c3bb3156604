"""Batched HTTP serving around the port's ``Detector`` (deployment layer).

Counterpart of ``yolo_continuous_tpu/serve.py``, with the same endpoints,
JSON fields, stats keys and defaults:

- **micro-batching**: concurrent requests are coalesced into one device
  batch (up to ``batch_size``, waiting at most ``max_wait_ms``); partial
  batches are padded to the fixed size, so every batch runs the same shapes.
  The engine runs one batch at construction (warm-up), which also builds the
  CUDA kernels, so the first client never waits for ``nvcc`` or cuDNN's
  first choice.
- **one host-to-device and one device-to-host copy per batch**: requests are
  letterboxed on the client's thread into uint8, copied into a (pinned, on
  CUDA) uint8 batch, scaled to 0..1 on the device (the same fp32 values as
  ``img / 255.0`` on the host), and the four result tensors come back in
  one copy; the letterbox-inverse box mapping runs on the host in numpy
  (``ops.nms.yolo_correct_boxes_np``).
- **request prioritization**: ``low`` < ``normal`` < ``high`` < ``urgent``;
  the queue is a priority queue (FIFO within a level); an ``urgent``
  request makes the worker dispatch without waiting for fill.
- **streaming**: ``POST /detect/stream`` takes 4-byte big-endian
  length-prefixed JPEG/PNG frames (Content-Length or chunked body) and
  streams one NDJSON line per frame back, in frame order; frames are
  pipelined through the engine (up to ``batch_size`` in flight).
- **hot reload**: ``POST /models/<m>/reload`` and the ``reload_every``
  watcher swap a model's weights with no restart.

Endpoints:
    POST /detect          body = JPEG/PNG bytes -> JSON {boxes, scores,
                          classes, labels} in original-image pixels
                          (x1, y1, x2, y2). ``?conf=`` tightens the
                          threshold for this request; ``?priority=``
                          low|normal|high|urgent or an integer, clamped to
                          that range.
    POST /detect/<model>  the same, routed to a named model
    POST /detect/stream   frames in, NDJSON out (also /detect/<model>/stream)
    POST /models/<m>/reload  re-read <m>'s checkpoint and swap it in
    GET  /healthz, /models, /stats

Deliberate fixes of four faults of the JAX package's server:

1. A reload that raises no longer kills the watcher thread: the error is
   counted in the ``reload_errors`` stat and the watcher keeps polling;
   ``POST /models/<m>/reload`` answers a JSON error (500), not the standard
   library's bare 500.
2. A reload reads (and under ``fuse`` re-parameterizes) the checkpoint
   outside the detector lock (``Detector.read_weights``) and holds the lock
   only for the swap (``Detector.swap_weights``), so requests keep being
   served while a checkpoint loads.
3. An integer priority is clamped to ``PRIORITIES``' range.
4. A ``/detect`` body is read through ``_BodyReader`` (Content-Length or
   chunked); a body with neither header closes the connection after the
   answer, so no unread bytes desync the next request.

The watcher polls the file that ``Detector`` would read
(``detect_api.weights_source``): the ``.pth`` beside the plan's
``save_path``, then the port's ``<stem>.train.pt`` that ``Trainer`` writes,
then ``save_path`` itself, so a trainer next door is picked up live.

Run: python -m yolo_continuous_tpu_torch.serve cfg/chip_tiny.yaml --port 8100 [--device cpu]
Multi-model: ... serve cfg/a.yaml --model tiny=cfg/b.yaml --model x=cfg/c.yaml
"""
from __future__ import annotations

import collections
import itertools
import json
import os
import queue
import threading
import time
import traceback
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np
import torch

from .detect_api import weights_source
from .ops.nms import yolo_correct_boxes_np
from .ops.preprocess import cv2, letterbox

# request priority levels (names accepted at the HTTP layer); higher runs
# sooner. URGENT also skips the batching fill-wait.
PRIORITIES = {"low": -1, "normal": 0, "high": 1, "urgent": 2}
URGENT = PRIORITIES["urgent"]
MAX_BODY = 64 << 20          # bytes of one image or stream frame


def clamp_priority(value: int) -> int:
    """An integer priority, clamped to ``PRIORITIES``' range."""
    return max(min(PRIORITIES.values()), min(URGENT, int(value)))


def detect_rows(det, images, conf: float, nms: float, max_det: int) -> np.ndarray:
    """One detector call on a (bs, H, W, 3) float 0..1 batch, its four
    results brought to the host in one copy: (bs, max_det, 7) fp32 rows of
    box (normalized x1 y1 x2 y2), score, class, valid."""
    boxes, scores, classes, valid = det(images, conf, nms, max_det)
    rows = torch.cat([boxes.float(), scores.float()[..., None], classes.float()[..., None],
                      valid.float()[..., None]], -1)
    return rows.cpu().numpy()


def answers(rows: np.ndarray, shapes, size, labels) -> List[dict]:
    """``detect_rows``' rows of the first ``len(shapes)`` images -> one JSON
    answer each, boxes mapped back to the original (h, w) in ``shapes``
    (letterbox inverse for the whole batch at once, on the host)."""
    shapes = np.asarray(shapes, np.float32)
    mapped_all = yolo_correct_boxes_np(rows[: len(shapes), :, :4], size, shapes, True)
    out = []
    for i in range(len(shapes)):
        m = rows[i, :, 6] > 0
        xyxy = mapped_all[i][:, [1, 0, 3, 2]][m]
        cls = rows[i, m, 5].astype(int)
        out.append({
            "boxes": [[float(v) for v in b] for b in xyxy],
            "scores": [float(s) for s in rows[i, m, 4]],
            "classes": [int(c) for c in cls],
            "labels": [labels[c] if 0 <= c < len(labels) else str(c) for c in cls],
        })
    return out


class _Pending:
    __slots__ = ("image", "shape", "event", "result")

    def __init__(self, image, shape):
        self.image = image          # letterboxed (H, W, 3) uint8
        self.shape = shape          # original (h, w)
        self.event = threading.Event()
        self.result = None


class BatchingEngine:
    """Coalesces requests into fixed-size device batches."""

    def __init__(self, detector, batch_size: int = 8, max_wait_ms: float = 5.0,
                 conf: float = 0.3, nms: float = 0.45, max_det: int = 100,
                 submit_timeout: float = 60.0, warmup: bool = True,
                 reload_every: float = 0.0):
        """``reload_every`` > 0 starts a checkpoint watcher: every that many
        seconds it polls the modification time of the file the detector's
        weights come from (``detect_api.weights_source``) and hot-reloads on
        a change."""
        self.det = detector
        self.batch_size = batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self.conf, self.nms, self.max_det = conf, nms, max_det
        self.submit_timeout = submit_timeout
        self.size = (detector.plan.image_size, detector.plan.image_size)
        self.device = torch.device(getattr(detector, "device", "cpu"))
        # the host side of the one copy a batch; pinned so the copy is DMA
        self._host = torch.zeros((batch_size, *self.size, 3), dtype=torch.uint8,
                                 pin_memory=self.device.type == "cuda")
        # priority queue of (-priority, seq, pending): higher priority first,
        # FIFO within a level (seq is a global monotonic counter)
        self._q: "queue.PriorityQueue" = queue.PriorityQueue()
        self._seq = itertools.count()
        self._stop = threading.Event()
        # serializes weight swaps (reload) against in-flight batches
        self._det_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._t0 = time.monotonic()
        self._n_requests = 0
        self._n_timeouts = 0
        self._n_batches = 0
        self._n_batched_reqs = 0
        self._n_errors = 0
        self._n_reloads = 0
        self._n_reload_errors = 0
        self._n_by_priority = collections.Counter()
        self._latencies = collections.deque(maxlen=512)  # seconds
        # per batch: (host ms outside the device call, ms of the call and its
        # copy out); read by chip_smoke.py, not served
        self.batch_times = collections.deque(maxlen=4096)
        if warmup:
            # one batch now: builds the kernels and warms cuDNN, so a cold
            # start never turns into a client timeout
            self._run(torch.zeros((batch_size, *self.size, 3), dtype=torch.uint8))
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self.reload_every = reload_every
        if reload_every and reload_every > 0:
            threading.Thread(target=self._watch_checkpoint, daemon=True).start()

    # -- client side -----------------------------------------------------
    def submit(self, rgb: np.ndarray, timeout: Optional[float] = None,
               conf: Optional[float] = None, priority: int = 0) -> Optional[dict]:
        """Block until this image's detections are ready; None on timeout.

        ``conf``: a per-request score threshold, a host-side post-filter on
        the batch's results (it can only tighten the engine's threshold).
        ``priority``: a PRIORITIES value (clamped to their range)."""
        t_in = time.monotonic()
        priority = clamp_priority(priority)
        img, _, _ = letterbox(rgb, self.size, (114, 114, 114))
        p = _Pending(img, rgb.shape[:2])
        with self._stats_lock:
            self._n_requests += 1
            self._n_by_priority[priority] += 1
        self._q.put((-priority, next(self._seq), p))
        if not p.event.wait(self.submit_timeout if timeout is None else timeout):
            with self._stats_lock:
                self._n_timeouts += 1
            return None
        with self._stats_lock:
            self._latencies.append(time.monotonic() - t_in)
        res = p.result
        if conf is not None and res is not None and "scores" in res and conf > self.conf:
            keep = [i for i, s in enumerate(res["scores"]) if s >= conf]
            res = {k: ([v[i] for i in keep] if isinstance(v, list) else v)
                   for k, v in res.items()}
        return res

    def stats(self) -> dict:
        """Live counters for the /stats monitoring endpoint."""
        with self._stats_lock:
            lats = sorted(self._latencies)
            n_b = self._n_batches
            out = {
                "uptime_s": round(time.monotonic() - self._t0, 1),
                "requests": self._n_requests,
                "timeouts": self._n_timeouts,
                "batches": n_b,
                "mean_batch_fill": round(self._n_batched_reqs / n_b, 3) if n_b else None,
                "batch_errors": self._n_errors,
                "reloads": self._n_reloads,
                "reload_errors": self._n_reload_errors,
                "by_priority": {name: self._n_by_priority[v] for name, v in PRIORITIES.items()
                                if self._n_by_priority[v]},
            }
            if lats:
                out["latency_ms"] = {
                    "p50": round(lats[len(lats) // 2] * 1e3, 2),
                    "p95": round(lats[int(len(lats) * 0.95) if len(lats) > 1 else 0] * 1e3, 2),
                    "max": round(lats[-1] * 1e3, 2),
                    "window": len(lats),
                }
        return out

    # -- device side -----------------------------------------------------
    def _drain(self) -> List[_Pending]:
        neg, _, first = self._q.get()    # block for the first request
        if first is None:                # close()
            return []
        batch = [first]
        if -neg >= URGENT:
            # urgent head-of-line: take what is already queued, never wait
            while len(batch) < self.batch_size:
                try:
                    batch.append(self._q.get_nowait()[2])
                except queue.Empty:
                    break
            return batch
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.batch_size:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                neg, _, p = self._q.get(timeout=left)
            except queue.Empty:
                break
            if p is None:                # close(): run what is here, then stop
                break
            batch.append(p)
            if -neg >= URGENT:           # an urgent arrival ends the wait
                break
        return batch

    def _run(self, images_u8: torch.Tensor) -> np.ndarray:
        """One device call on a (bs, H, W, 3) uint8 host batch: one copy in,
        scaled to 0..1 on the device (the same fp32 values as ``img / 255.0``
        on the host), ``detect_rows``."""
        x = images_u8.to(self.device, non_blocking=True).float()
        # a true division: CUDA divides by a Python number as a product with
        # its reciprocal, which can differ in the last bit
        x = x / torch.full((), 255.0, device=x.device)
        with self._det_lock:             # never mid-swap (reload)
            return detect_rows(self.det, x, self.conf, self.nms, self.max_det)

    def _loop(self):
        while not self._stop.is_set():
            try:
                batch = self._drain()
            except Exception:
                continue
            if not batch:
                continue
            try:
                t0 = time.perf_counter()
                self._host.zero_()
                for i, p in enumerate(batch):
                    self._host[i] = torch.from_numpy(p.image)
                t1 = time.perf_counter()
                rows = self._run(self._host)
                t2 = time.perf_counter()
                results = answers(rows, [p.shape for p in batch], self.size,
                                  self.det.plan.labels)
                for p, res in zip(batch, results):
                    p.result = res
                self.batch_times.append(((t1 - t0 + time.perf_counter() - t2) * 1e3,
                                         (t2 - t1) * 1e3))
            except Exception as e:      # a bad batch must not kill serving
                with self._stats_lock:
                    self._n_errors += 1
                for p in batch:
                    p.result = {"error": f"{type(e).__name__}: {e}"}
            finally:
                with self._stats_lock:
                    self._n_batches += 1
                    self._n_batched_reqs += len(batch)
                for p in batch:
                    p.event.set()

    def reload(self, path: Optional[str] = None) -> bool:
        """Hot-swap the detector's weights from its checkpoint without
        dropping queued requests: the checkpoint is read (and re-fused) with
        no lock held, and the swap itself is serialized against the worker's
        device call, so every batch runs on one consistent set of weights.
        Returns False when there is no checkpoint; a read or swap that
        raises counts in ``reload_errors`` and re-raises."""
        try:
            served = self.det.read_weights(path)
            if served is None:
                return False
            with self._det_lock:
                self.det.swap_weights(served)
        except Exception:
            with self._stats_lock:
                self._n_reload_errors += 1
            raise
        with self._stats_lock:
            self._n_reloads += 1
        return True

    def weights_path(self) -> Optional[str]:
        """The file the detector's weights would be read from now."""
        save_path = getattr(self.det.plan, "save_path", None)
        return weights_source(save_path) if save_path else None

    def _watch_checkpoint(self):
        """Poll the weights file's mtime; reload on change. A reload that
        raises is counted (``reload_errors``) and the watcher keeps polling;
        it retries when the file changes again."""
        last = None
        while not self._stop.wait(self.reload_every):
            path = self.weights_path()
            try:
                key = (path, os.path.getmtime(path)) if path else None
            except OSError:
                key = None
            if key is None or key == last:
                continue
            try:
                if self.reload():
                    last = key
            except Exception:           # counted in reload_errors; keep polling
                traceback.print_exc()
                last = key

    def close(self):
        """Stop the worker (after the batch it runs) and the watcher."""
        self._stop.set()
        self._q.put((float("inf"), next(self._seq), None))


class _BodyReader:
    """Exact-read view of an HTTP request body, Content-Length or
    ``Transfer-Encoding: chunked`` (the standard library does not de-chunk)."""

    def __init__(self, rfile, headers):
        self._rfile = rfile
        te = (headers.get("Transfer-Encoding") or "").lower()
        self._chunked = "chunked" in te
        self.framed = self._chunked or headers.get("Content-Length") is not None
        self._left = 0 if self._chunked else int(headers.get("Content-Length") or 0)
        self._chunk_left = 0
        self._eof = False

    def _read_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            part = self._rfile.read(n - len(out))
            if not part:
                break
            out += part
        return out

    def read(self, n: int) -> bytes:
        """Read exactly ``n`` bytes; a short result means the end of the body."""
        if self._eof or n <= 0:
            return b""
        if not self._chunked:
            n = min(n, self._left)
            out = self._read_exact(n)
            self._left -= len(out)
            if self._left <= 0 or len(out) < n:
                self._eof = True
            return out
        out = b""
        while len(out) < n:
            if self._chunk_left == 0:
                line = self._rfile.readline(130)
                if not line:
                    self._eof = True
                    break
                line = line.strip().split(b";")[0]
                if not line:                      # CRLF between chunks
                    continue
                try:
                    size = int(line, 16)
                except ValueError:
                    self._eof = True
                    break
                if size == 0:                     # last-chunk; trailers
                    while True:
                        t = self._rfile.readline(1024)
                        if t in (b"", b"\r\n", b"\n"):
                            break
                    self._eof = True
                    break
                self._chunk_left = size
            take = min(n - len(out), self._chunk_left)
            part = self._read_exact(take)
            out += part
            self._chunk_left -= len(part)
            if len(part) < take:
                self._eof = True
                break
        return out

    def drain(self) -> None:
        """Read and drop whatever is left of the body."""
        while self.read(1 << 16):
            pass


class _Server(ThreadingHTTPServer):
    """The standard threading server with a listen backlog for many clients
    (the standard library's 5 resets the connections of a burst of 64)."""
    request_queue_size = 128
    daemon_threads = True


def make_multi_server(models: dict, host: str = "127.0.0.1", port: int = 8100,
                      batch_size: int = 8, max_wait_ms: float = 5.0, conf: float = 0.3,
                      nms: float = 0.45, submit_timeout: float = 60.0, warmup: bool = True,
                      reload_every: float = 0.0, device="cuda") -> ThreadingHTTPServer:
    """Multi-model server: ``models`` maps name -> plan (or ``(plan,
    detector)`` to reuse a built Detector; a plan alone builds
    ``Detector(plan, device=device)``). Each model gets its own
    BatchingEngine (own queue, worker, stats); ``POST /detect/<name>``
    routes to it, ``POST /detect`` to the first entry. Build only (the
    caller runs serve_forever())."""
    from .detect_api import Detector

    engines, default_name = {}, None
    for name, entry in models.items():
        plan, det = entry if isinstance(entry, tuple) else (entry, None)
        det = det or Detector(plan, device=device)
        engines[name] = BatchingEngine(det, batch_size, max_wait_ms, conf, nms,
                                       submit_timeout=submit_timeout, warmup=warmup,
                                       reload_every=reload_every)
        default_name = default_name or name

    def _model_info(name):
        e = engines[name]
        return {"image_size": e.size[0], "batch": e.batch_size, "conf": e.conf, "nms": e.nms,
                "labels": list(e.det.plan.labels)}

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 so the stream endpoint can send a chunked response;
        # every other response carries Content-Length.
        protocol_version = "HTTP/1.1"

        def log_message(self, *a):     # quiet
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = urllib.parse.urlparse(self.path).path
            if path == "/healthz":
                d = engines[default_name]
                self._json(200, {"ok": True, "batch": d.batch_size, "image_size": d.size[0],
                                 "models": {n: {"batch": e.batch_size, "image_size": e.size[0]}
                                            for n, e in engines.items()}})
            elif path == "/models":
                self._json(200, {n: _model_info(n) for n in engines})
            elif path == "/stats":
                self._json(200, {n: e.stats() for n, e in engines.items()})
            else:
                self._json(404, {"error": "not found"})

        def _reload(self, name):
            eng = engines.get(name)
            if eng is None:
                self._json(404, {"error": f"unknown model {name!r}", "models": list(engines)})
                return
            try:
                ok = eng.reload()
            except Exception as e:
                self._json(500, {"reloaded": False, "model": name,
                                 "error": f"{type(e).__name__}: {e}"})
                return
            self._json(200 if ok else 404,
                       {"reloaded": ok, "model": name,
                        **({} if ok else
                           {"error": f"no checkpoint at {eng.det.plan.save_path!r}"})})

        def do_POST(self):
            url = urllib.parse.urlparse(self.path)
            parts = url.path.strip("/").split("/")
            reader = _BodyReader(self.rfile, self.headers)
            if not reader.framed:
                # no Content-Length and not chunked: answer, then close, so
                # that unframed bytes never parse as the next request
                self.close_connection = True
            if parts[0] == "models" and len(parts) == 3 and parts[2] == "reload":
                reader.drain()
                self._reload(parts[1])
                return
            stream = parts[-1] == "stream" and len(parts) >= 2
            if stream:
                parts = parts[:-1]
            if parts[0] != "detect" or len(parts) > 2:
                self.close_connection = True     # body not consumed
                self._json(404, {"error": "not found"})
                return
            name = parts[1] if len(parts) == 2 else default_name
            engine = engines.get(name)
            if engine is None:
                self.close_connection = True
                self._json(404, {"error": f"unknown model {name!r}", "models": list(engines)})
                return
            if cv2 is None:
                self.close_connection = True
                self._json(503, {"error": "cv2 is not available: the server cannot decode "
                                          "image bytes on this host"})
                return
            q = urllib.parse.parse_qs(url.query)
            try:
                req_conf = float(q["conf"][0]) if "conf" in q else None
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": "bad conf parameter"})
                return
            pri_s = q.get("priority", ["normal"])[0]
            try:
                priority = PRIORITIES[pri_s] if pri_s in PRIORITIES else clamp_priority(pri_s)
            except ValueError:
                self.close_connection = True
                self._json(400, {"error": f"bad priority {pri_s!r} (one of {list(PRIORITIES)} "
                                          "or an int)"})
                return
            if stream:
                self._stream(engine, reader, req_conf, priority)
                return
            raw = reader.read(MAX_BODY + 1)
            if len(raw) > MAX_BODY:
                self.close_connection = True
                self._json(413, {"error": f"image body over {MAX_BODY} bytes"})
                return
            bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR) if raw else None
            if bgr is None:
                self._json(400, {"error": "undecodable image"})
                return
            res = engine.submit(cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB), conf=req_conf,
                                priority=priority)
            if res is None:
                self._json(503, {"error": "timeout"})
                return
            self._json(500 if "error" in res else 200, res)

        def _stream(self, engine, reader, req_conf, priority):
            """POST /detect[/<model>]/stream: frames in, NDJSON out.

            Body: repeated [4-byte big-endian length][image bytes] records
            (Content-Length or chunked). Response: one JSON line per frame,
            in frame order, written as each result completes; up to
            ``batch_size`` frames are in flight, so one streaming client
            still fills device batches."""
            self.close_connection = True         # chunked one-shot
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(obj):
                data = (json.dumps(obj) + "\n").encode()
                self.wfile.write(b"%x\r\n" % len(data) + data + b"\r\n")
                self.wfile.flush()

            def flush_one(entry):
                i, fut = entry
                if fut is None:
                    emit({"frame": i, "error": "undecodable image"})
                    return
                res = fut.result()
                emit({"frame": i, "error": "timeout"} if res is None else {"frame": i, **res})

            depth = max(2, engine.batch_size)
            pending = collections.deque()
            n_frames = 0
            try:
                with ThreadPoolExecutor(max_workers=depth) as ex:
                    while True:
                        hdr = reader.read(4)
                        if len(hdr) < 4:
                            break
                        n = int.from_bytes(hdr, "big")
                        if n == 0 or n > MAX_BODY:
                            emit({"frame": n_frames, "error": f"bad frame length {n}"})
                            break
                        raw = reader.read(n)
                        if len(raw) < n:
                            emit({"frame": n_frames, "error": "truncated frame"})
                            break
                        bgr = cv2.imdecode(np.frombuffer(raw, np.uint8), cv2.IMREAD_COLOR)
                        if bgr is None:
                            pending.append((n_frames, None))
                        else:
                            rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                            pending.append((n_frames, ex.submit(
                                engine.submit, rgb, conf=req_conf, priority=priority)))
                        n_frames += 1
                        while len(pending) >= depth:
                            flush_one(pending.popleft())
                    while pending:
                        flush_one(pending.popleft())
                emit({"done": True, "frames": n_frames})
                self.wfile.write(b"0\r\n\r\n")
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass                             # client went away

    srv = _Server((host, port), Handler)
    srv.engines = engines
    srv.engine = engines[default_name]      # the single-model attribute
    return srv


def make_server(plan, host: str = "127.0.0.1", port: int = 8100, batch_size: int = 8,
                max_wait_ms: float = 5.0, conf: float = 0.3, nms: float = 0.45,
                detector=None, submit_timeout: float = 60.0, warmup: bool = True,
                reload_every: float = 0.0, device="cuda") -> ThreadingHTTPServer:
    """Single-model server (the multi-model server with one entry)."""
    return make_multi_server({"default": (plan, detector)}, host, port, batch_size,
                             max_wait_ms, conf, nms, submit_timeout, warmup, reload_every,
                             device)


def main(argv=None):
    import argparse

    from .config.plan import TrainPlan, check_file
    from .utils.timing import select_device

    ap = argparse.ArgumentParser(description="Batched detection server (PyTorch port)")
    ap.add_argument("cfg", help="default model's train-plan YAML")
    ap.add_argument("--model", action="append", default=[], metavar="NAME=CFG",
                    help="serve an additional named model (POST /detect/NAME); repeatable")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--max-wait-ms", type=float, default=5.0)
    ap.add_argument("--conf", type=float, default=0.3)
    ap.add_argument("--nms", type=float, default=0.45)
    ap.add_argument("--submit-timeout", type=float, default=60.0,
                    help="seconds a request waits for its batch result")
    ap.add_argument("--reload-every", type=float, default=0.0, metavar="SECONDS",
                    help="poll each model's weights file this often and hot-reload on "
                         "change (continuous-training serving); 0 disables")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = select_device(args.device)

    models = {"default": TrainPlan(check_file(args.cfg))}
    for spec in args.model:
        name, _, cfg = spec.partition("=")
        if not cfg:
            ap.error(f"--model expects NAME=CFG, got {spec!r}")
        models[name] = TrainPlan(check_file(cfg))
    srv = make_multi_server(models, args.host, args.port, args.batch, args.max_wait_ms,
                            args.conf, args.nms, submit_timeout=args.submit_timeout,
                            reload_every=args.reload_every, device=device)
    print(f"serving {list(models)} on {args.host}:{args.port} (batch {args.batch}, {device})",
          flush=True)
    srv.serve_forever()


if __name__ == "__main__":
    main()
