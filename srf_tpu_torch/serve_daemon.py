"""Dynamic-batching serving daemon (port of ``srf_tpu/serve_daemon.py``):
coalesce concurrent requests into one batched forward and decode.

- ``BatchingFrontend``: a thread-safe queue and scheduler thread.
  ``submit(feats) -> Future``; a batch closes when ``max_batch`` requests
  wait or ``max_wait_ms`` after the worker took the oldest, then one
  ``Recognizer.transcribe_batch_detailed`` call (one forward, one batched
  decode) serves the whole batch.
- ``StreamingService``: live streaming sessions of SRF models, one
  ``StreamingPool`` per model, one batched step per tick.
- ``ModelFleet``: named models behind one daemon.
- a TCP front end (``python -m srf_tpu_torch.serve_daemon
  --daemon-port=N <model flags>``) with a length-prefixed JSON + raw
  float32 protocol, byte-compatible with the JAX package's (either
  package's client helpers talk to either daemon), the ``request()`` /
  ``stream_*()`` / ``stats_request()`` client helpers, an HTTP/JSON
  gateway (``--daemon-http-port``), a hot-reload poller
  (``--daemon-reload-secs``) and multi-model fleets (``--daemon-fleet``).
  Stdlib only, besides numpy and the Recognizer.

Batches are padded to ``max_batch`` rows by default (short dummy
utterances, results discarded), so that a padded width is one forward
shape: cuDNN's algorithm search (``cudnn.benchmark``) then runs once per
width, not once per (count, width) pair.
"""

import itertools
import json
import queue
import socket
import socketserver
import struct
import sys
import threading
import time
from concurrent.futures import Future
from typing import NamedTuple

import numpy as np

from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.ops.routing_cuda import sequential_routing_cuda
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.utils.log2utt import ids_to_utt
from srf_tpu_torch.utils.profiler import mark, span

_DUMMY_FRAMES = 16


class _Request(NamedTuple):
    """A queued request: its id, its submit time (ns, the spans' clock),
    what it asks and the Future that takes its answer."""

    key: int
    submitted_ns: int
    feats: np.ndarray
    corpus: str
    detailed: bool
    n_best: int
    future: Future


# request and batch ids, unique in the process, so that the spans of the
# front ends of a fleet never share a key
_REQUEST_IDS = itertools.count()
_BATCH_IDS = itertools.count()


class BatchingFrontend:
    """Coalesces concurrent transcription requests into batched forwards.

    ``beam_width`` is a server-level setting (one decode per batch);
    ``corpus`` rendering is per request (host-side only).

    Spans and marks (``utils/profiler.py``): ``srf.serve.submit`` (a mark
    in the caller's thread, keyed by the request's id), then in the worker
    ``srf.serve.wait`` (blocked on an empty queue), ``srf.serve.hold``
    (from the first request taken until the batch closes, keyed by the
    batch's id, with a ``srf.serve.take`` mark a request, keyed as its
    submit) and ``srf.serve.batch`` (the Recognizer's call and the
    results, keyed by the batch's id): the three cover the worker's loop.
    ``stats`` counts the served requests and batches, each batch's
    requests (``batch_sizes``), and sums seconds over them:
    ``queue_wait_s`` (submit to take, a request), ``hold_s`` and
    ``batch_s`` (a batch's spans).
    """

    def __init__(self, recognizer, max_batch=16, max_wait_ms=10.0,
                 beam_width=None, pad_batch=True, logger=None):
        self.rec = recognizer
        self.max_batch = max(1, int(max_batch))
        self.max_wait_s = max(0.0, float(max_wait_ms)) / 1000.0
        self.beam_width = beam_width
        self.pad_batch = pad_batch
        self.logger = logger
        self.stats = {"requests": 0, "batches": 0, "batch_sizes": [],
                      "queue_wait_s": 0.0, "hold_s": 0.0, "batch_s": 0.0}
        self._q = queue.Queue()
        self._closed = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, feats, corpus="timit", detailed=False, n_best=1):
        """feats: [T, feat_dim] numpy -> Future of (ids, text) — or, with
        ``detailed``, of the full scoring dict ({ids, text, score,
        avg_logp, confidence, frames, times, token_confidences},
        Recognizer.transcribe_batch_detailed). ``n_best`` > 1 adds that
        many ranked hypotheses under "nbest" (beam decodes only).

        Shape-validates HERE so one malformed request is rejected alone
        instead of failing every co-batched request when the batched
        forward raises."""
        if self._closed:
            raise RuntimeError("BatchingFrontend is closed")
        feats = np.asarray(feats, np.float32)
        feat_dim = self.rec.config.feat_dim
        if feats.ndim != 2 or feats.shape[1] != feat_dim:
            raise ValueError(
                "expected [T, %d] features, got %s" % (feat_dim, feats.shape)
            )
        fut = Future()
        key = next(_REQUEST_IDS)
        submitted = mark("srf.serve.submit", key)
        self._q.put(_Request(key, submitted, feats, corpus, detailed,
                             max(1, int(n_best)), fut))
        return fut

    def transcribe(self, feats, corpus="timit", timeout=None):
        return self.submit(feats, corpus).result(timeout=timeout)

    def close(self):
        self._closed = True
        self._q.put(None)
        self._worker.join()

    # -- scheduler ------------------------------------------------------

    def _gather(self):
        """Block for the first request, then keep the batch open until it
        is full or max_wait_ms after the worker TOOK the first request.
        Returns (batch id, requests, seconds they waited from submit to
        take, seconds held), or None at shutdown."""
        with span("srf.serve.wait"):
            first = self._q.get()
        if first is None:
            return None
        key = next(_BATCH_IDS)
        waited = 0
        with span("srf.serve.hold", key) as hold:
            waited += mark("srf.serve.take", first.key) - first.submitted_ns
            batch = [first]
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    # propagate shutdown after serving what we have
                    self._q.put(None)
                    break
                waited += mark("srf.serve.take", item.key) - item.submitted_ns
                batch.append(item)
        return key, batch, waited / 1e9, (hold.end_ns - hold.start_ns) / 1e9

    def _run(self):
        while True:
            gathered = self._gather()
            if gathered is None:
                return
            key, batch, waited_s, held_s = gathered
            with span("srf.serve.batch", key) as served:
                if not self._serve(batch):
                    continue
            self.stats["requests"] += len(batch)
            self.stats["batches"] += 1
            self.stats["batch_sizes"].append(len(batch))
            self.stats["queue_wait_s"] += waited_s
            self.stats["hold_s"] += held_s
            self.stats["batch_s"] += (served.end_ns - served.start_ns) / 1e9

    def _serve(self, batch):
        """One Recognizer call for ``batch`` and its results into the
        requests' Futures; False where the call raised (every Future then
        holds the error)."""
        feats_list = [request.feats for request in batch]
        n_real = len(feats_list)
        if self.pad_batch and n_real < self.max_batch:
            dummy = np.zeros(
                (_DUMMY_FRAMES, feats_list[0].shape[1]), np.float32
            )
            feats_list = feats_list + [dummy] * (self.max_batch - n_real)
        # one n-best depth per batch: the deepest requested; each
        # request's list is trimmed to its own depth below
        batch_nbest = max(request.n_best for request in batch)
        try:
            results = self.rec.transcribe_batch_detailed(
                feats_list, beam_width=self.beam_width,
                n_best=batch_nbest,
            )
        except Exception as exc:  # propagate to every waiter
            for request in batch:
                request.future.set_exception(exc)
            return False
        raw_vocab = [
            t if t != " " else "<SPACE>" for t in self.rec.vocab
        ]
        for detail, request in zip(results[:n_real], batch):
            detail = dict(
                detail,
                text=ids_to_utt(detail["ids"], raw_vocab, request.corpus),
            )
            if request.n_best > 1 and "nbest" in detail:
                detail["nbest"] = [
                    dict(h, text=ids_to_utt(h["ids"], raw_vocab,
                                            request.corpus))
                    for h in detail["nbest"][:request.n_best]
                ]
            else:
                detail.pop("nbest", None)
            request.future.set_result(
                detail if request.detailed else (detail["ids"], detail["text"])
            )
        if self.logger:
            self.logger.info(
                "served batch of %d (padded to %d)", n_real,
                len(feats_list),
            )
        return True


class StreamingService:
    """Live streaming sessions behind the daemon, one StreamingPool per
    served model: N concurrent sessions advance in one batched step per
    tick (streaming.StreamingPool), so many live audio streams share the
    card the way batched offline requests do.

    Sessions are slot-bound: ``open`` claims a slot (error when all busy
    — admission control, not queueing: a live stream cannot wait),
    ``push`` buffers frames and runs pool ticks until nothing is ready
    (co-pending sessions' blocks ride the same steps; their partials
    accumulate for THEIR next push), ``flush`` finalizes and frees the
    slot. Greedy partials stream from every push; with ``beam_width`` the
    flush returns the streamed-beam final hypothesis instead.
    """

    def __init__(self, recognizer, slots=4, chunk=8, beam_width=None):
        self.rec = recognizer
        self.pool = recognizer.streaming_pool(
            slots, chunk=chunk, beam_width=beam_width
        )
        self.beam_width = beam_width
        self._lock = threading.Lock()
        self._free = list(range(slots))
        self._sessions = {}  # session id -> slot
        self._pending = {}  # slot -> greedy ids not yet returned
        self._counter = 0

    def open(self):
        with self._lock:
            if not self._free:
                raise RuntimeError(
                    "no free streaming slots (serving %d live sessions)"
                    % len(self._sessions)
                )
            slot = self._free.pop()
            self._counter += 1
            sid = "s%d" % self._counter
            self._sessions[sid] = slot
            self._pending[slot] = []
            return sid

    def _slot(self, sid):
        slot = self._sessions.get(sid)
        if slot is None:
            raise KeyError("unknown streaming session %r" % sid)
        return slot

    def push(self, sid, feats):
        """Buffer frames, tick the pool dry, return NEW greedy partial ids
        for this session (other sessions' outputs accumulate as pending)."""
        with self._lock:
            slot = self._slot(sid)
            self.pool.push(slot, np.asarray(feats, np.float32))
            while True:
                got = self.pool.step()
                if not got:
                    break
                for s, ids in got.items():
                    self._pending[s].extend(ids)
            out = self._pending[slot]
            self._pending[slot] = []
            return out

    def flush(self, sid):
        """Finalize the session, free its slot. Returns (ids, score or
        None, complete): with a streamed beam, ids is the COMPLETE final
        hypothesis (replaces earlier partials, complete=True); greedy, the
        remaining tail ids (complete=False)."""
        with self._lock:
            slot = self._slot(sid)
            result = self.pool.flush(slot)
            pending = self._pending.pop(slot, [])
            del self._sessions[sid]
            self._free.append(slot)
            if self.beam_width:
                ids, score = result
                return list(ids), float(score), True
            return pending + list(result), None, False


class ModelFleet:
    """Named models behind one daemon (multi-tenant serving).

    One Recognizer + one BatchingFrontend per model (different models can
    never share a batched forward, so the queues are separate; the card
    is shared, and --tpu-serve-quant=int8 keeps each model's weights in
    int8). Requests name
    their model in the header; omitted = the default model, so
    single-model clients keep working unchanged.
    """

    def __init__(self, frontends, default, stream_slots=4, stream_chunk=8,
                 stream_beam=0):
        if default not in frontends:
            raise ValueError("default model %r not in fleet %s"
                             % (default, sorted(frontends)))
        self.frontends = dict(frontends)
        self.default = default
        self._stream_cfg = (stream_slots, stream_chunk,
                            stream_beam if stream_beam > 1 else None)
        self._streams = {}
        self._stream_lock = threading.Lock()

    def stream_service(self, name=None):
        """Per-model StreamingService, created on first use (streaming
        needs the SRF front-end; non-SRF models error here, loudly)."""
        name = name or self.default
        frontend = self.get(name)  # validates the model name
        with self._stream_lock:
            service = self._streams.get(name)
            if service is None:
                slots, chunk, beam = self._stream_cfg
                service = StreamingService(
                    frontend.rec, slots=slots, chunk=chunk, beam_width=beam
                )
                self._streams[name] = service
            return service

    def get(self, name=None):
        name = name or self.default
        frontend = self.frontends.get(name)
        if frontend is None:
            raise KeyError(
                "unknown model %r (serving: %s)"
                % (name, ", ".join(sorted(self.frontends)))
            )
        return frontend

    def stats(self):
        """Per-model stats + the default model's flat at top level (the
        single-model snapshot shape stays backward compatible)."""

        def one(frontend):
            stats = frontend.stats
            n_req, n_bat = stats["requests"], stats["batches"]
            return {
                "requests": n_req,
                "batches": n_bat,
                "mean_batch": n_req / n_bat if n_bat else 0.0,
                "mean_queue_wait_ms": (1e3 * stats["queue_wait_s"] / n_req
                                       if n_req else 0.0),
                "mean_hold_ms": (1e3 * stats["hold_s"] / n_bat
                                 if n_bat else 0.0),
                "mean_batch_ms": (1e3 * stats["batch_s"] / n_bat
                                  if n_bat else 0.0),
                "serving_step": int(frontend.rec.step),
                "quantized": bool(frontend.rec.quantized),
                "max_batch": frontend.max_batch,
            }

        snapshot = one(self.get())
        snapshot["models"] = {
            name: one(f) for name, f in sorted(self.frontends.items())
        }
        snapshot["default_model"] = self.default
        # the process's K1 launches so far (ops/routing_cuda): how a client
        # sees that its requests ran the SDR kernel
        snapshot["sdr_fwd_launches"] = sequential_routing_cuda.launches
        return snapshot

    def close(self):
        for frontend in self.frontends.values():
            frontend.close()


# ---- wire protocol ----------------------------------------------------
# request:  u32 header_len | header JSON | raw float32 payload
#           header: {"shape": [T, D], "corpus": "timit",
#                    "model": "<fleet name>"?}
#           or {"op": "stats"} (no payload) -> health/metrics snapshot
#           or live streaming (SRF models; one request per op):
#              {"op": "stream_open", "model": ...?} -> {"session": id}
#              {"op": "stream_push", "session": id, "shape": [n, D]}
#                + payload -> new greedy partials {"ids", "text"}
#              {"op": "stream_flush", "session": id} -> final result
#                ("complete": true = whole hypothesis, beam; false =
#                 remaining greedy tail) + frees the slot
# response: u32 body_len | body JSON {"ids": [...], "text": "..."} or
#           {"error": "..."}


def _response_body(detail):
    """JSON-safe response body from a transcribe_batch_detailed dict —
    shared by the TCP and HTTP front-ends so both protocols expose the
    same fields (incl. per-symbol emission frames + start times)."""
    body = {
        "ids": [int(i) for i in detail["ids"]],
        "text": detail["text"],
        "score": detail["score"],
        "avg_logp": detail["avg_logp"],
        "confidence": detail["confidence"],
        "frames": [int(f) for f in detail["frames"]],
        "times": detail["times"],
        "token_confidences": detail["token_confidences"],
    }
    if "nbest" in detail:
        body["nbest"] = [
            {"ids": [int(i) for i in h["ids"]], "text": h["text"],
             "score": h["score"]}
            for h in detail["nbest"]
        ]
    return body


def _read_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf += chunk
    return buf


def _send_msg(sock, obj):
    body = json.dumps(obj).encode("utf-8")
    sock.sendall(struct.pack(">I", len(body)) + body)


def request(host, port, feats, corpus="timit", timeout=60.0, model=None,
            detailed=False, nbest=1):
    """Client helper: one transcription round trip. -> (ids, text).

    ``model`` selects a fleet model by name (None = the daemon default);
    ``detailed`` returns the full response dict instead (adds score /
    avg_logp / confidence / frames / times / token_confidences, and —
    with ``nbest`` > 1 — that many ranked hypotheses)."""
    feats = np.ascontiguousarray(feats, np.float32)
    head = {"shape": list(feats.shape), "corpus": corpus}
    if nbest and nbest > 1:
        head["nbest"] = int(nbest)
    if model is not None:
        head["model"] = model
    header = json.dumps(head).encode("utf-8")
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(struct.pack(">I", len(header)) + header)
        sock.sendall(feats.tobytes())
        (n,) = struct.unpack(">I", _read_exact(sock, 4))
        body = json.loads(_read_exact(sock, n).decode("utf-8"))
    if "error" in body:
        raise RuntimeError("server error: %s" % body["error"])
    if detailed:
        return body
    return list(body["ids"]), body["text"]


def stream_open(host, port, model=None, timeout=30.0):
    """Client helper: claim a live streaming session -> session id."""
    head = {"op": "stream_open"}
    if model is not None:
        head["model"] = model
    return _round_trip(host, port, head, timeout=timeout)["session"]


def stream_push(host, port, session, feats, corpus="timit", timeout=60.0):
    """Client helper: stream frames into a session -> (ids, text) NEW
    greedy partials since the last push."""
    feats = np.ascontiguousarray(feats, np.float32)
    head = {"op": "stream_push", "session": session,
            "shape": list(feats.shape), "corpus": corpus}
    body = _round_trip(host, port, head, payload=feats.tobytes(),
                       timeout=timeout)
    return list(body["ids"]), body["text"]


def stream_flush(host, port, session, corpus="timit", timeout=60.0):
    """Client helper: finalize a session. Returns the response dict —
    ``complete=True`` means ids/text are the WHOLE final hypothesis
    (streamed beam; replaces earlier partials, with ``score``),
    ``False`` the remaining greedy tail (append to earlier partials)."""
    head = {"op": "stream_flush", "session": session, "corpus": corpus}
    return _round_trip(host, port, head, timeout=timeout)


def _round_trip(host, port, head, payload=b"", timeout=60.0):
    header = json.dumps(head).encode("utf-8")
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(struct.pack(">I", len(header)) + header)
        if payload:
            sock.sendall(payload)
        (n,) = struct.unpack(">I", _read_exact(sock, 4))
        body = json.loads(_read_exact(sock, n).decode("utf-8"))
    if "error" in body:
        raise RuntimeError("server error: %s" % body["error"])
    return body


def stats_request(host, port, timeout=10.0):
    """Client helper: health/metrics snapshot (no model forward)."""
    header = json.dumps({"op": "stats"}).encode("utf-8")
    with socket.create_connection((host, port), timeout=timeout) as sock:
        sock.sendall(struct.pack(">I", len(header)) + header)
        (n,) = struct.unpack(">I", _read_exact(sock, 4))
        return json.loads(_read_exact(sock, n).decode("utf-8"))


class _Handler(socketserver.BaseRequestHandler):
    def handle(self):
        fleet = self.server.fleet
        try:
            (n,) = struct.unpack(">I", _read_exact(self.request, 4))
            header = json.loads(_read_exact(self.request, n).decode("utf-8"))
            op = header.get("op")
            if op == "stats":
                _send_msg(self.request, fleet.stats())
                return
            if op in ("stream_open", "stream_push", "stream_flush"):
                self._handle_stream(fleet, op, header)
                return
            frontend = fleet.get(header.get("model"))
            t, d = header["shape"]
            raw = _read_exact(self.request, int(t) * int(d) * 4)
            feats = np.frombuffer(raw, np.float32).reshape(int(t), int(d))
            detail = frontend.submit(
                feats, corpus=header.get("corpus", "timit"), detailed=True,
                n_best=int(header.get("nbest", 1)),
            ).result()
            _send_msg(self.request, _response_body(detail))
        except Exception as exc:  # noqa: BLE001 — report to the client
            try:
                _send_msg(self.request, {"error": str(exc)})
            except OSError:
                pass

    def _handle_stream(self, fleet, op, header):
        """Live-session ops: open claims a slot, push streams frames and
        returns greedy partials, flush finalizes (+frees the slot)."""
        service = fleet.stream_service(header.get("model"))
        if op == "stream_open":
            _send_msg(self.request, {"session": service.open()})
            return
        sid = header["session"]
        corpus = header.get("corpus", "timit")
        rec = service.rec
        raw_vocab = [t if t != " " else "<SPACE>" for t in rec.vocab]
        if op == "stream_push":
            t, d = header["shape"]
            raw = _read_exact(self.request, int(t) * int(d) * 4)
            feats = np.frombuffer(raw, np.float32).reshape(int(t), int(d))
            ids = service.push(sid, feats)
            _send_msg(self.request, {
                "ids": [int(i) for i in ids],
                "text": ids_to_utt(ids, raw_vocab, corpus),
            })
        else:  # stream_flush
            ids, score, complete = service.flush(sid)
            body = {
                "ids": [int(i) for i in ids],
                "text": ids_to_utt(ids, raw_vocab, corpus),
                "complete": complete,
            }
            if score is not None:
                body["score"] = score
            _send_msg(self.request, body)


class DaemonServer(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, addr, fleet):
        super().__init__(addr, _Handler)
        self.fleet = fleet


# ---- HTTP/JSON gateway -------------------------------------------------
# REST analog of the TCP protocol, for clients without the struct-framed
# helper (curl, load balancers, non-Python services). Shares the SAME
# fleet of BatchingFrontends, so HTTP and TCP requests coalesce into the
# same batched forwards.
#
#   POST /v1/transcribe   {"feats": [[...f32...], ...], "corpus": "timit",
#                          "model": "<fleet name>"?}
#                      or {"shape": [T, D], "data_b64": "<raw f32 LE>",
#                          "corpus": "...", "model": ...}
#                      -> {"ids": [...], "text": "..."}
#   POST /v1/transcribe_long  same body (+"endpoint_blanks"?,
#                      "max_segment_s"?) -> {"segments": [...]} —
#                      silence-segmented long-form (SRF models)
#   GET  /v1/health    -> the stats snapshot (no model forward)


def make_http_server(fleet, host, port):
    import base64
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet; daemon has its own logger
            pass

        def _reply(self, code, obj):
            body = json.dumps(obj).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path != "/v1/health":
                return self._reply(404, {"error": "unknown path"})
            self._reply(200, dict(fleet.stats(), status="ok"))

        def _read_feats(self, req):
            if "data_b64" in req:
                t, d = (int(v) for v in req["shape"])
                raw = base64.b64decode(req["data_b64"])
                return np.frombuffer(raw, "<f4").reshape(t, d)
            return np.asarray(req["feats"], np.float32)

        def do_POST(self):
            if self.path not in ("/v1/transcribe", "/v1/transcribe_long"):
                return self._reply(404, {"error": "unknown path"})
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n).decode("utf-8"))
                frontend = fleet.get(req.get("model"))
                feats = self._read_feats(req)
                corpus = req.get("corpus", "timit")
                if self.path == "/v1/transcribe_long":
                    # long-form: silence-segmented, timestamped segments
                    # (SRF models; runs a private streaming session, so
                    # it does NOT contend for the live-stream slots)
                    segments = frontend.rec.transcribe_long(
                        feats, corpus=corpus,
                        beam_width=frontend.beam_width,
                        endpoint_blanks=int(req.get("endpoint_blanks", 25)),
                        max_segment_s=float(req.get("max_segment_s", 30.0)),
                    )
                    return self._reply(200, {"segments": segments})
                detail = frontend.submit(
                    feats, corpus=corpus, detailed=True,
                    n_best=int(req.get("nbest", 1)),
                ).result()
                self._reply(200, _response_body(detail))
            except Exception as exc:  # noqa: BLE001 — report to the client
                self._reply(400, {"error": str(exc)})

    server = ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    return server


def start_reload_poller(recognizer, interval_s, logger=None,
                        stop_event=None):
    """Hot-reload poller: every ``interval_s`` seconds ask the recognizer
    to swap to a newer checkpoint if one appeared (training runs
    alongside serving; a new epoch/average lands and the daemon picks it
    up without a restart). Errors are logged and polling continues — a
    half-written checkpoint must not kill the server."""
    stop_event = stop_event or threading.Event()

    def _poll():
        while not stop_event.wait(interval_s):
            try:
                new = recognizer.reload()
                if new is not None and logger:
                    logger.info("reload poller: now serving step %d", new)
            except Exception as exc:  # noqa: BLE001 — keep serving
                if logger:
                    logger.warning("reload poll failed (will retry): %s",
                                   exc)

    thread = threading.Thread(target=_poll, name="srf-reload", daemon=True)
    thread.start()
    return stop_event, thread


def build_fleet(model_configs, max_batch=16, max_wait_ms=10.0,
                reload_secs=0.0, logger=None, stream_slots=4,
                stream_chunk=8, stream_beam=0):
    """Build a ModelFleet from {name: config} (insertion order; first =
    default). Each model gets its own Recognizer, BatchingFrontend and —
    when ``reload_secs`` > 0 — hot-reload poller. Returns
    (fleet, stop_events)."""
    frontends, stops = {}, []
    default = None
    for name, config in model_configs.items():
        recognizer = Recognizer(config, logger=logger)
        beam = config.decoding_beam_width
        frontends[name] = BatchingFrontend(
            recognizer, max_batch=max_batch, max_wait_ms=max_wait_ms,
            beam_width=(beam if beam and beam > 1 else None), logger=logger,
        )
        if reload_secs and reload_secs > 0:
            stop, _ = start_reload_poller(
                recognizer, reload_secs, logger=logger)
            stops.append(stop)
        if default is None:
            default = name
        if logger:
            logger.info("fleet model %r ready (beam %s)", name, beam)
    return ModelFleet(
        frontends, default, stream_slots=stream_slots,
        stream_chunk=stream_chunk, stream_beam=stream_beam,
    ), stops


def load_fleet_spec(path, base_argv, logger=None):
    """Parse a fleet spec JSON into {name: parsed config}.

    Spec: ``{"default": "name"?, "models": {"name": {"args": [...]}}}`` —
    each model's args are a full trainer-style flag list (conf files via
    --config work as usual); ``base_argv`` flags are prepended so shared
    flags can be given once on the daemon command line (a model's own
    args win, CLI-wins semantics ending at the model level)."""
    with open(path) as f:
        spec = json.load(f)
    models = spec.get("models")
    if not models:
        raise ValueError("fleet spec %s has no models" % path)
    configs = {}
    order = list(models)
    default = spec.get("default") or order[0]
    if default in order:  # serve the default first (it compiles first)
        order.remove(default)
        order.insert(0, default)
    for name in order:
        entry = models[name]
        args = entry.get("args") if isinstance(entry, dict) else entry
        if not isinstance(args, list):
            raise ValueError(
                "fleet model %r: expected {'args': [...]} or a flag list"
                % name
            )
        configs[name] = ParseOption(
            ["fleet:%s" % name] + list(base_argv) + [str(a) for a in args],
            logger, is_print_opts=False,
        ).args
    return configs


def serve(config, host="127.0.0.1", port=8764, max_batch=16,
          max_wait_ms=10.0, reload_secs=0.0, http_port=None, logger=None,
          ready_event=None, model_configs=None, stream_slots=4,
          stream_chunk=8, stream_beam=0):
    """Blocking server loop (Ctrl-C to stop). ``http_port`` (0 = pick an
    ephemeral port) also serves the REST gateway, sharing the same
    batching frontends (HTTP and TCP requests coalesce into the same
    forwards). ``model_configs`` ({name: config}, first = default)
    serves a multi-model fleet; ``config`` alone is the single-model
    case (fleet of one, name "default")."""
    logger = logger or Logger(name="srf_daemon", level=Logger.INFO).logger
    if model_configs is None:
        model_configs = {"default": config}
    fleet, stop_reloads = build_fleet(
        model_configs, max_batch=max_batch, max_wait_ms=max_wait_ms,
        reload_secs=reload_secs, logger=logger, stream_slots=stream_slots,
        stream_chunk=stream_chunk, stream_beam=stream_beam,
    )
    if reload_secs and reload_secs > 0:
        logger.info("hot reload: polling for new checkpoints every %.1f s",
                    reload_secs)
    server = DaemonServer((host, port), fleet)
    http_server = None
    if http_port is not None:
        http_server = make_http_server(fleet, host, http_port)
        threading.Thread(
            target=http_server.serve_forever, name="srf-http", daemon=True
        ).start()
        logger.info("HTTP gateway on %s:%d (POST /v1/transcribe, "
                    "GET /v1/health)", host, http_server.server_address[1])
    logger.info(
        "serving %d model(s) [%s] on %s:%d (max_batch %d, max_wait %.1f ms)",
        len(fleet.frontends), ", ".join(sorted(fleet.frontends)),
        host, server.server_address[1], max_batch, max_wait_ms,
    )
    if ready_event is not None:
        ready_event.server = server
        ready_event.http_server = http_server
        ready_event.set()
    try:
        server.serve_forever()
    finally:
        for stop in stop_reloads:
            stop.set()
        if http_server is not None:
            http_server.shutdown()
            http_server.server_close()
        server.server_close()
        fleet.close()


def main(argv=None):
    logger = Logger(name="srf_daemon", level=Logger.INFO).logger
    argv = list(argv or sys.argv)
    host, port, max_batch, max_wait = "127.0.0.1", 8764, 16, 10.0
    reload_secs, http_port, fleet_path = 0.0, None, None
    stream_slots, stream_chunk, stream_beam = 4, 8, 0
    filtered = []
    it = iter(argv)
    for arg in it:
        if arg.startswith("--daemon-host="):
            host = arg.split("=", 1)[1]
        elif arg.startswith("--daemon-port="):
            port = int(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-http-port="):
            http_port = int(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-max-batch="):
            max_batch = int(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-max-wait-ms="):
            max_wait = float(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-reload-secs="):
            reload_secs = float(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-fleet="):
            fleet_path = arg.split("=", 1)[1]
        elif arg.startswith("--daemon-stream-slots="):
            stream_slots = int(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-stream-chunk="):
            stream_chunk = int(arg.split("=", 1)[1])
        elif arg.startswith("--daemon-stream-beam="):
            stream_beam = int(arg.split("=", 1)[1])
        else:
            filtered.append(arg)
    if fleet_path:
        # multi-model: per-model flags come from the spec; remaining
        # command-line flags are shared prefixes for every model
        model_configs = load_fleet_spec(
            fleet_path, filtered[1:], logger=logger)
        config = next(iter(model_configs.values()))
    else:
        model_configs = None
        config = ParseOption(filtered, logger, is_print_opts=False).args
    serve(config, host=host, port=port, max_batch=max_batch,
          max_wait_ms=max_wait, reload_secs=reload_secs,
          http_port=http_port, logger=logger, model_configs=model_configs,
          stream_slots=stream_slots, stream_chunk=stream_chunk,
          stream_beam=stream_beam)


if __name__ == "__main__":
    main()
