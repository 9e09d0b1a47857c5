"""The port's serving daemon (srf_tpu_torch.serve_daemon) on the CPU, with
a small SRF on numpy-seeded weights: batched answers equal one-by-one
answers, a lone request is flushed by the wait timeout, concurrent
requests coalesce, the front end's spans and counters, TCP and HTTP round
trips, a two-model fleet, hot reload of a checkpoint saved while serving,
live streaming sessions over TCP, errors reaching every waiter, the CLI
in a subprocess, and the JAX package's client
(srf_tpu.serve_daemon.request) talking to the port's server (the wire
format is the same: the same reply as the port's own client).

Servers bind port 0 and are shut down in ``finally``; every socket,
Future and Event wait has its own timeout (<= 30 s)."""

import base64
import contextlib
import http.client
import json
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import torch

import srf_tpu.serve_daemon as jax_daemon
import srf_tpu_torch.serve_daemon as sd
from srf_tpu_torch import convert
from srf_tpu_torch.config import Logger, ParseOption
from srf_tpu_torch.serve import Recognizer
from srf_tpu_torch.utils import profiler
from srf_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_parity import random_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB = os.path.join(REPO, "egs", "data", "timit_62.vocab")
HOST = "127.0.0.1"
WAIT = 30.0
MODEL_FLAGS = [
    "--feat-dim=123", "--model-encoder-num=3",
    "--model-caps-primary-num=6", "--model-caps-primary-dim=4",
    "--model-caps-convolution-num=5", "--model-caps-convolution-dim=4",
    "--model-caps-class-dim=4", "--model-caps-type=naive",
    "--model-caps-context=True", "--model-caps-iter=1",
    "--model-caps-window-lpad=1", "--model-caps-window-rpad=1",
    "--model-conv-filter-num=8",
]
LOGGER = Logger(name="test_torch_serve_daemon", level=Logger.WARN).logger


def _weights(seed):
    from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter

    flax_model = FlaxSequenceRouter(
        feat_dim=123, class_n=63, enc_num=3, caps_primary_num=6,
        caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
        caps_class_dim=4, caps_iter=1, lpad=1, rpad=1, is_context=True,
        conv_layer_num=2, conv_filter_num=8, caps_type="naive")
    return convert.flax_to_state_dict(
        random_flax_variables(flax_model, 123, seed=seed))


def _argv(ckpt, *extra):
    return ["serve", "--path-base=%s" % ckpt, "--path-vocab=%s" % VOCAB,
            "--path-ckpt=%s" % ckpt, "--device=cpu", *MODEL_FLAGS, *extra]


def _config(ckpt, *extra):
    return ParseOption(_argv(ckpt, *extra), LOGGER, is_print_opts=False).args


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """(checkpoint directory holding step 1, its Recognizer, features)."""
    base = tmp_path_factory.mktemp("daemon")
    manager = CheckpointManager(str(base / "ckpt"))
    manager.save(1, {"step": 1, "model": _weights(21)})
    manager.close()
    ckpt = str(base / "ckpt")
    rng = np.random.RandomState(3)
    feats = [rng.randn(n, 123).astype(np.float32)
             for n in (150, 230, 140, 200)]
    return ckpt, Recognizer(_config(ckpt), logger=LOGGER), feats


@contextlib.contextmanager
def _daemon(config=None, **kwargs):
    """sd.serve in a thread on port 0; yields the ready event (its
    ``server`` and ``http_server``); shut down on the way out."""
    ready = threading.Event()
    thread = threading.Thread(
        target=sd.serve, daemon=True,
        kwargs=dict(config=config, host=HOST, port=0, logger=LOGGER,
                    ready_event=ready, **kwargs))
    thread.start()
    assert ready.wait(timeout=WAIT)
    try:
        yield ready
    finally:
        ready.server.shutdown()
        thread.join(timeout=WAIT)
        assert not thread.is_alive()


def test_coalesced_batches_match_single_requests(served):
    _, rec, feats = served
    want = [rec.transcribe(f, beam_width=4) for f in feats]
    frontend = sd.BatchingFrontend(rec, max_batch=4, max_wait_ms=500,
                                   beam_width=4)
    try:
        barrier = threading.Barrier(4)
        futures = [None] * 4

        def client(i):
            barrier.wait(timeout=WAIT)
            futures[i] = frontend.submit(feats[i])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT)
        got = [f.result(timeout=WAIT) for f in futures]
    finally:
        frontend.close()
    # equal to one-by-one: each request padded alone to 256 frames, and in
    # the batch (to 256) with 16-frame dummies
    assert got == want
    assert frontend.stats["requests"] == 4
    assert max(frontend.stats["batch_sizes"]) > 1


def test_single_request_flushed_by_timeout(served):
    _, rec, feats = served
    frontend = sd.BatchingFrontend(rec, max_batch=16, max_wait_ms=5)
    try:
        got = frontend.transcribe(feats[0], timeout=WAIT)
        detail = frontend.submit(feats[1], detailed=True).result(timeout=WAIT)
        with pytest.raises(ValueError, match="expected"):
            frontend.submit(np.zeros((5, 7), np.float32))
    finally:
        frontend.close()
    assert got == rec.transcribe(feats[0])
    want = rec.transcribe_batch_detailed(
        [feats[1]] + [np.zeros((16, 123), np.float32)] * 15)[0]
    assert detail == want
    assert frontend.stats["batch_sizes"] == [1, 1]
    with pytest.raises(RuntimeError, match="closed"):
        frontend.submit(feats[0])


def test_a_failed_batch_fails_every_waiter(served):
    _, rec, feats = served

    class Broken:
        config, vocab = rec.config, rec.vocab

        def transcribe_batch_detailed(self, *args, **kwargs):
            raise RuntimeError("forward failed")

    frontend = sd.BatchingFrontend(Broken(), max_batch=2, max_wait_ms=200)
    try:
        futures = [frontend.submit(f) for f in feats[:2]]
        for future in futures:
            with pytest.raises(RuntimeError, match="forward failed"):
                future.result(timeout=WAIT)
    finally:
        frontend.close()


def test_the_front_end_spans_every_request_and_covers_its_loop(served):
    _, rec, feats = served
    start = time.perf_counter_ns()
    frontend = sd.BatchingFrontend(rec, max_batch=3, max_wait_ms=20)
    try:
        futures = [frontend.submit(f) for f in feats + feats[:2]]
        for future in futures:
            future.result(timeout=WAIT)
    finally:
        frontend.close()
    worker = frontend._worker.ident
    ring = [s for s in profiler.spans() if s.start_ns >= start]

    def named(name):
        return [s for s in ring if s.name == name]

    submits = {s.key: s for s in named("srf.serve.submit")}
    takes = {s.key: s for s in named("srf.serve.take")}
    assert len(submits) == 6 and set(takes) == set(submits)
    for key, submit in submits.items():
        assert submit.thread == threading.get_ident()
        assert takes[key].thread == worker
        assert takes[key].parent == "srf.serve.hold"
        assert submit.start_ns <= takes[key].start_ns
    holds = {s.key: s for s in named("srf.serve.hold")}
    batches = {s.key: s for s in named("srf.serve.batch")}
    assert set(holds) == set(batches)
    assert len(batches) == frontend.stats["batches"] >= 2
    # every take lies in one hold
    for take in takes.values():
        assert sum(h.start_ns <= take.start_ns <= h.end_ns
                   for h in holds.values()) == 1
    # the Recognizer's parts, once a batch, inside it
    for name in ("srf.serve.pad", "srf.serve.forward", "srf.serve.decode",
                 "srf.serve.results"):
        parts = named(name)
        assert len(parts) == len(batches)
        assert {p.parent for p in parts} == {"srf.serve.batch"}
    # wait, hold and batch take turns on the worker and cover its loop
    loop = sorted((s for s in ring if s.thread == worker and s.name in (
        "srf.serve.wait", "srf.serve.hold", "srf.serve.batch")),
        key=lambda s: s.start_ns)
    assert [s.name for s in loop] == ["srf.serve.wait", "srf.serve.hold",
                                      "srf.serve.batch"] * len(batches) + [
                                          "srf.serve.wait"]
    gaps = [b.start_ns - a.end_ns for a, b in zip(loop, loop[1:])]
    assert min(gaps) >= 0
    assert sum(gaps) < 0.05 * (loop[-1].end_ns - loop[0].start_ns)
    # the counters sum the same intervals
    stats = frontend.stats
    assert stats["requests"] == 6 and sum(stats["batch_sizes"]) == 6
    assert stats["queue_wait_s"] == pytest.approx(sum(
        takes[k].start_ns - submits[k].start_ns for k in submits) / 1e9)
    assert stats["hold_s"] == pytest.approx(sum(
        h.end_ns - h.start_ns for h in holds.values()) / 1e9)
    assert stats["batch_s"] == pytest.approx(sum(
        b.end_ns - b.start_ns for b in batches.values()) / 1e9)


def test_the_stats_snapshot_reports_the_front_ends_means(served):
    _, rec, _ = served
    frontend = sd.BatchingFrontend(rec, max_batch=4, max_wait_ms=5)
    try:
        fleet = sd.ModelFleet({"a": frontend}, "a")
        empty = fleet.stats()
        frontend.stats.update(requests=4, batches=2, queue_wait_s=0.2,
                              hold_s=0.03, batch_s=0.1)
        snapshot = fleet.stats()
    finally:
        frontend.close()
    for key in ("mean_queue_wait_ms", "mean_hold_ms", "mean_batch_ms"):
        assert empty[key] == 0.0
    for one in (snapshot, snapshot["models"]["a"]):
        assert one["mean_queue_wait_ms"] == pytest.approx(50.0)
        assert one["mean_hold_ms"] == pytest.approx(15.0)
        assert one["mean_batch_ms"] == pytest.approx(50.0)


def test_tcp_round_trip_and_the_jax_client(served):
    ckpt, rec, feats = served
    with _daemon(_config(ckpt), max_batch=4, max_wait_ms=5) as ready:
        port = ready.server.server_address[1]
        for f in feats[:2]:
            got = sd.request(HOST, port, f, timeout=WAIT)
            assert got == rec.transcribe(f)
        body = sd.request(HOST, port, feats[2], detailed=True, timeout=WAIT)
        want = rec.transcribe_batch_detailed(
            [feats[2]] + [np.zeros((16, 123), np.float32)] * 3)[0]
        assert body == sd._response_body(want)
        # the JAX package's client, the same bytes on the wire
        assert jax_daemon.request(HOST, port, feats[2], detailed=True,
                                  timeout=WAIT) == body
        assert jax_daemon.request(HOST, port, feats[0],
                                  timeout=WAIT) == rec.transcribe(feats[0])
        stats = sd.stats_request(HOST, port, timeout=WAIT)
        assert stats == jax_daemon.stats_request(HOST, port, timeout=WAIT)
        assert stats["requests"] == 5 and stats["batches"] >= 1
        assert stats["serving_step"] == 1 and stats["max_batch"] == 4
        assert stats["quantized"] is False
        assert stats["sdr_fwd_launches"] == 0  # the CPU runs no kernel
        with pytest.raises(RuntimeError, match="server error: expected"):
            sd.request(HOST, port, np.zeros((4, 9), np.float32),
                       timeout=WAIT)


def _http(port, method, path, body=None):
    conn = http.client.HTTPConnection(HOST, port, timeout=WAIT)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        reply = conn.getresponse()
        return reply.status, json.loads(reply.read().decode("utf-8"))
    finally:
        conn.close()


def test_http_gateway(served):
    ckpt, rec, feats = served
    with _daemon(_config(ckpt), max_batch=2, max_wait_ms=5,
                 http_port=0) as ready:
        port = ready.http_server.server_address[1]
        want = sd._response_body(rec.transcribe_batch_detailed(
            [feats[1], np.zeros((16, 123), np.float32)])[0])
        status, body = _http(port, "POST", "/v1/transcribe",
                             {"feats": feats[1].tolist()})
        assert status == 200 and body == want
        raw = base64.b64encode(feats[1].astype("<f4").tobytes()).decode()
        status, body = _http(port, "POST", "/v1/transcribe",
                             {"shape": list(feats[1].shape), "data_b64": raw})
        assert status == 200 and body == want
        status, body = _http(port, "GET", "/v1/health")
        assert status == 200 and body["status"] == "ok"
        assert body["requests"] == 2
        long_feats = np.concatenate([feats[0], np.zeros((80, 123),
                                                        np.float32), feats[3]])
        status, body = _http(port, "POST", "/v1/transcribe_long",
                             {"feats": long_feats.tolist(),
                              "endpoint_blanks": 3, "max_segment_s": 1.0})
        assert status == 200
        assert body["segments"] == json.loads(json.dumps(rec.transcribe_long(
            long_feats, endpoint_blanks=3, max_segment_s=1.0)))
        assert _http(port, "GET", "/nope")[0] == 404
        assert _http(port, "POST", "/v1/transcribe", {"feats": [[1.0]]})[0] \
            == 400


def test_fleet_routes_each_model(served, tmp_path):
    ckpt, rec, feats = served
    other = tmp_path / "other"
    other.mkdir()
    torch.save(_weights(22), other / "model.pt")
    spec = tmp_path / "fleet.json"
    spec.write_text(json.dumps({"default": "b", "models": {
        "a": {"args": ["--path-ckpt=%s" % ckpt]},
        "b": {"args": ["--path-ckpt=%s" % other]}}}))
    configs = sd.load_fleet_spec(str(spec), _argv(ckpt)[1:], LOGGER)
    assert list(configs) == ["b", "a"]
    other_rec = Recognizer(_config(str(other)), logger=LOGGER)
    with _daemon(model_configs=configs, max_batch=2,
                 max_wait_ms=5) as ready:
        port = ready.server.server_address[1]
        assert sd.request(HOST, port, feats[0], model="a",
                          timeout=WAIT) == rec.transcribe(feats[0])
        assert sd.request(HOST, port, feats[0],
                          timeout=WAIT) == other_rec.transcribe(feats[0])
        assert rec.transcribe(feats[0]) != other_rec.transcribe(feats[0])
        with pytest.raises(RuntimeError, match="unknown model"):
            sd.request(HOST, port, feats[0], model="c", timeout=WAIT)
        stats = sd.stats_request(HOST, port, timeout=WAIT)
        assert stats["default_model"] == "b"
        assert stats["models"]["a"]["requests"] == 1
        assert stats["models"]["b"]["serving_step"] == 0


def test_hot_reload_over_tcp(served, tmp_path):
    ckpt, _, feats = served
    reload_dir = tmp_path / "ckpt"
    manager = CheckpointManager(str(reload_dir))
    manager.save(1, {"step": 1, "model": _weights(21)})
    with _daemon(_config(str(reload_dir)), max_batch=2, max_wait_ms=5,
                 reload_secs=0.2) as ready:
        port = ready.server.server_address[1]
        assert sd.stats_request(HOST, port, timeout=WAIT)[
            "serving_step"] == 1
        manager.save(2, {"step": 2, "model": _weights(23)})
        deadline = time.monotonic() + WAIT
        serving = 1
        while serving != 2 and time.monotonic() < deadline:
            time.sleep(0.2)
            serving = sd.stats_request(HOST, port,
                                       timeout=WAIT)["serving_step"]
        assert serving == 2, "the poller never swapped in step 2"
        want = Recognizer(_config(str(reload_dir)), logger=LOGGER)
        assert want.step == 2
        assert sd.request(HOST, port, feats[0],
                          timeout=WAIT) == want.transcribe(feats[0])
    manager.close()


@pytest.mark.parametrize("beam", [0, 4])
def test_streaming_sessions_over_tcp(served, beam):
    ckpt, rec, feats = served
    want = []
    for f in feats[:2]:
        session = rec.streaming_session(chunk=4,
                                        beam_width=beam or None)
        ids = session.push(f)
        tail = session.flush()
        want.append(tail if beam else (ids + tail, None))
    with _daemon(_config(ckpt), max_batch=2, max_wait_ms=5, stream_slots=2,
                 stream_chunk=4, stream_beam=beam) as ready:
        port = ready.server.server_address[1]
        s0 = sd.stream_open(HOST, port, timeout=WAIT)
        s1 = jax_daemon.stream_open(HOST, port, timeout=WAIT)
        with pytest.raises(RuntimeError, match="no free streaming slots"):
            sd.stream_open(HOST, port, timeout=WAIT)
        got = {s0: [], s1: []}
        for lo in range(0, max(f.shape[0] for f in feats[:2]), 11):
            for sid, f in ((s0, feats[0]), (s1, feats[1])):
                if lo < f.shape[0]:
                    ids, _ = sd.stream_push(HOST, port, sid, f[lo : lo + 11],
                                            timeout=WAIT)
                    got[sid].extend(ids)
        for i, sid in enumerate((s0, s1)):
            body = sd.stream_flush(HOST, port, sid, timeout=WAIT)
            assert body["complete"] is bool(beam)
            if beam:
                assert body["ids"] == want[i][0]
                np.testing.assert_allclose(body["score"], want[i][1],
                                           rtol=1e-5)
            else:
                assert got[sid] + body["ids"] == want[i][0]
        s2 = sd.stream_open(HOST, port, timeout=WAIT)
        with pytest.raises(RuntimeError, match="unknown streaming"):
            sd.stream_flush(HOST, port, s0, timeout=WAIT)
        sd.stream_flush(HOST, port, s2, timeout=WAIT)


def test_cli_serves_in_a_subprocess(served, tmp_path):
    ckpt, rec, feats = served
    proc = subprocess.Popen(
        [sys.executable, "-m", "srf_tpu_torch.serve_daemon",
         *_argv(ckpt)[1:], "--daemon-port=0", "--daemon-max-batch=2",
         "--daemon-max-wait-ms=5"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    try:
        port = None
        deadline = time.monotonic() + 120
        lines = []
        while port is None and time.monotonic() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            found = re.search(r"serving 1 model\(s\).* on [\d.]+:(\d+)",
                              line)
            if found:
                port = int(found.group(1))
        assert port, "".join(lines[-20:])
        assert sd.request(HOST, port, feats[1],
                          timeout=WAIT) == rec.transcribe(feats[1])
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=WAIT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=WAIT)
