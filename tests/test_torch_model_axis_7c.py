"""A sharded SRF's streaming and wavefront (ROADMAP item 7c) against JAX.

The model's class-capsule layer is sharded over a (data 1, model 2) mesh
(``apply_rules``: 6 classes, 3 a rank), the ranks real OS processes over
gloo (``_torch_dist_worker.py``'s ``model_axis_7c`` scenario), in eval
mode. JAX runs the unsharded flax model on the same weights (GSPMD's
partitioning does not change what it computes):

- the last layer's ``route_block`` with a nonzero carry and warm-up steps
  (``v_init``, ``step_valid``): K1-tp-stream's plain version, this rank's
  shard routed with its part of the carry and gathered; one two-row
  ``stream_step`` (a pool's rows at different window positions and
  warm-ups); and a ``StreamingTranscriber`` over one utterance, against
  JAX's ``route_block``, ``stream_step`` and ``StreamingTranscriber``;
- the wavefront forward (``routing_impl="wavefront"``: the last layer's
  softmax split in each loop step, its capsules gathered before its
  LayerNorm) against JAX's wavefront forward.

Limits are the unsharded tests' (``test_torch_streaming.py`` ATOL 3e-5,
``test_torch_wavefront.py`` 2e-5): float32 both, sums in other orders."""

import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.streaming import StreamingTranscriber as JaxStreamingTranscriber
from srf_tpu_torch import convert

from _torch_dist_worker import run_scenario
from _torch_parity import random_flax_variables

torch.set_num_threads(1)

FEAT, CLASSES = 10, 6
MODEL = dict(feat_dim=FEAT, class_n=CLASSES, enc_num=3, caps_primary_num=6,
             caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4,
             caps_class_dim=4, caps_iter=2, lpad=2, rpad=1, is_context=True,
             conv_layer_num=2, conv_filter_num=8, caps_type="naive")
STREAM_ATOL, WAVEFRONT_ATOL = 3e-5, 2e-5
CHUNK, K = 8, 8
LPOST, OFFSETS = [2, 3], np.array([[2, 1, -1], [0, -1, -3]])


def _arrays():
    rng = np.random.RandomState(9)
    n, d = MODEL["caps_conv_num"], MODEL["caps_conv_dim"]
    arrays = {
        "rb/u_ctx": rng.randn(2, 3 + K, n, d).astype(np.float32),
        "rb/v_init": (0.3 * rng.randn(2, CLASSES, 4)).astype(np.float32),
        "rb/valid": np.arange(K) >= 3,
        "raw": rng.randn(53, FEAT).astype(np.float32),
        "feats": rng.randn(2, 48, FEAT).astype(np.float32),
        "lens": np.array([48, 37], np.int32),
    }
    margin = 3  # stream_margin_posts at stride 2
    win = 4 * (K + 2 * margin)
    arrays["ss/window"] = rng.randn(2, win, FEAT).astype(np.float32)
    arrays["ss/length"] = np.array([win - 5, win], np.int64)
    arrays["ss/offsets"] = OFFSETS
    prev = (MODEL["caps_primary_num"], MODEL["caps_primary_dim"])
    for i, (out_n, out_d) in enumerate([(n, d), (n, d), (CLASSES, 4)]):
        arrays["ss/buf%d" % i] = rng.randn(2, 3, *prev).astype(np.float32)
        arrays["ss/vprev%d" % i] = (0.3 * rng.randn(2, out_n, out_d)).astype(
            np.float32)
        prev = (out_n, out_d)
    return arrays


@pytest.fixture(scope="module")
def pair():
    flax_model = FlaxSequenceRouter(**MODEL)
    variables = random_flax_variables(flax_model, FEAT, seed=4)
    return flax_model, variables


@pytest.fixture(scope="module")
def ranks(pair, tmp_path_factory):
    _, variables = pair
    workdir = tmp_path_factory.mktemp("model_axis_7c")
    spec = {"ranks": 2, "model": MODEL, "lpost": LPOST, "blank":
            CLASSES - 1, "chunk": CHUNK}
    state = convert.flax_to_state_dict(variables)
    np.savez(workdir / "inputs.npz", spec=json.dumps(spec), **_arrays(),
             **{"sd/" + k: v.numpy() for k, v in state.items()})
    return run_scenario("model_axis_7c", workdir, ranks=2)


def test_route_block_on_a_shard_matches_jax(pair, ranks):
    """A nonzero carry, 3 warm-up steps: the whole block and v_last on
    every rank (gathered), the warm-up steps zero."""
    flax_model, variables = pair
    a = _arrays()
    want = flax_model.apply(variables, jnp.asarray(a["rb/u_ctx"]),
                            MODEL["enc_num"] - 1, jnp.asarray(a["rb/v_init"]),
                            jnp.asarray(a["rb/valid"]),
                            method="route_block")
    for rank in ranks:
        assert int(rank["group_size"]) == 2
        np.testing.assert_allclose(rank["rb/out"], np.asarray(want[0]),
                                   atol=STREAM_ATOL)
        np.testing.assert_allclose(rank["rb/v_last"], np.asarray(want[1]),
                                   atol=STREAM_ATOL)
        assert not rank["rb/out"][:, :3].any()


def test_stream_step_on_a_shard_matches_jax_row_by_row(pair, ranks):
    """Two rows at their own window positions and warm-ups (a pool's
    tick): each row against JAX's one-row ``stream_step``."""
    flax_model, variables = pair
    a = _arrays()
    for row in range(2):
        want = flax_model.apply(
            variables, jnp.asarray(a["ss/window"][row:row + 1]),
            jnp.asarray(a["ss/length"][row]), jnp.asarray(LPOST[row]),
            [jnp.asarray(a["ss/buf%d" % i][row:row + 1]) for i in range(3)],
            [jnp.asarray(a["ss/vprev%d" % i][row:row + 1]) for i in range(3)],
            jnp.asarray(OFFSETS[row]), method="stream_step")
        for rank in ranks:
            np.testing.assert_allclose(rank["ss/logits"][row],
                                       np.asarray(want[0])[0],
                                       atol=STREAM_ATOL)
            for i in range(3):
                np.testing.assert_allclose(rank["ss/vprev%d" % i][row],
                                           np.asarray(want[2][i])[0],
                                           atol=STREAM_ATOL)
                np.testing.assert_allclose(rank["ss/buf%d" % i][row],
                                           np.asarray(want[1][i])[0],
                                           atol=STREAM_ATOL)


def test_streaming_transcriber_serves_a_sharded_model(pair, ranks):
    flax_model, variables = pair
    session = JaxStreamingTranscriber(flax_model, variables,
                                      blank_id=CLASSES - 1, chunk=CHUNK)
    raw = _arrays()["raw"]
    for start in range(0, raw.shape[0], 7):
        session.push(raw[start:start + 7])
    session.flush()
    for rank in ranks:
        assert rank["stream/logits"].shape == session.logits.shape
        np.testing.assert_allclose(rank["stream/logits"], session.logits,
                                   atol=STREAM_ATOL)


def test_sharded_wavefront_matches_jax_wavefront(pair, ranks):
    flax_model, variables = pair
    a = _arrays()
    wavefront = FlaxSequenceRouter(**MODEL, routing_impl="wavefront")
    want = np.asarray(wavefront.apply(variables, jnp.asarray(a["feats"]),
                                      jnp.asarray(a["lens"]), False))
    layered = np.asarray(flax_model.apply(variables, jnp.asarray(a["feats"]),
                                          jnp.asarray(a["lens"]), False))
    np.testing.assert_allclose(want, layered, atol=WAVEFRONT_ATOL)
    for rank in ranks:
        np.testing.assert_allclose(rank["wavefront/logits"], want,
                                   atol=WAVEFRONT_ATOL)
