"""The GPipe pipeline of the STF encoder in the port
(``parallel/pipeline.py``) against srf_tpu's on conftest's virtual
devices, with ``tests/test_pipeline.py``'s limits.

Ranks are real OS processes over gloo (``_torch_dist_worker.py``). A
4-block STF (D=16, 2 heads) in eval mode, dropout off:

- 2 stages with 2 and 4 microbatches, remat off and on (one spawn), and
  4 stages (one block a stage) with 2 and 4 microbatches: each rank's
  logits equal JAX's ``make_pipeline_apply_fn`` on a 2- or 4-device
  ``pipe`` mesh and the sequential model's (rtol 1e-4, atol 1e-5), and the
  gradients of mean(logits^2), summed over the stages, equal the
  sequential model's (rtol 1e-3, atol 1e-5; JAX's own test holds its
  pipeline's to the same);
- composed with data 2 (4 ranks, a (2, 2) mesh): each data shard's rows
  of the logits equal JAX's (2, 2) mesh's, and the gradients summed over
  the mesh are twice the global mean's (each shard's mean is over half
  the rows);
- ``python -m srf_tpu_torch.trainer_tf --tpu-pipeline-stages=2`` trains an
  epoch on two ranks with the STF-TIMIT recipe's dropouts at 0 and ends
  with the weights of the one-process run (the front end's dropout draws
  the same masks on stage 0: the step's generator is rank 0's);
- the microbatch count, the bubble and the stacked block parameters.
"""

import functools
import json
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from srf_tpu.models.stf import ConvEncoder as FlaxConvEncoder
from srf_tpu.ops.masking import get_padding_bias as jax_padding_bias
from srf_tpu.parallel.pipeline import make_pipeline_apply_fn as jax_pipeline
from srf_tpu.parallel.pipeline import stack_block_params as jax_stack
from srf_tpu_torch import convert, trainer_tf
from srf_tpu_torch.models.stf import ConvEncoder
from srf_tpu_torch.parallel import pipeline
from srf_tpu_torch.utils import checkpoint

from _torch_dist_worker import launch, run_scenario
from _torch_parity import flatten_tree, random_flax_variables
from test_torch_trainer_tf import STF_FLAGS, _argv, _make_corpus

torch.set_num_threads(1)

MODEL = dict(num_layers=4, d_model=16, num_heads=2, dff=32, feat_dim=20,
             vocab_n=11, input_dropout=0.0, inner_dropout=0.0,
             residual_dropout=0.0, attention_dropout=0.0, nfilt=4)
RUNS = [(2, False), (4, False), (2, True), (4, True)]


def _setup():
    flax_model = FlaxConvEncoder(**MODEL, attention_impl="plain")
    variables = random_flax_variables(flax_model, 20, seed=4)
    host = np.random.RandomState(0)
    feats = host.randn(8, 32, 20).astype(np.float32)
    lens = host.randint(16, 33, size=(8,)).astype(np.int32)
    return flax_model, variables, feats, lens


def _spawn(workdir, stages, ranks, runs):
    _, variables, feats, lens = _setup()
    state = convert.flax_to_state_dict(variables)
    spec = {"model": dict(MODEL, attention_impl="plain"), "stages": stages,
            "runs": runs}
    np.savez(workdir / "inputs.npz", spec=json.dumps(spec), feats=feats,
             inp_len=lens, **{"sd/" + k: v.numpy() for k, v in state.items()})
    return run_scenario("pipeline", workdir, ranks=ranks)


@pytest.fixture(scope="module")
def two_stages(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("pipe2"), 2, 2, RUNS)


@pytest.fixture(scope="module")
def four_stages(tmp_path_factory):
    """4 ranks, one block a stage: the middle stages send and receive at
    every tick but the first and last ones."""
    return _spawn(tmp_path_factory.mktemp("pipe4"), 4, 4,
                  [(2, False), (4, False)])


@functools.cache
def _jax_sequential():
    """The sequential flax model's logits and gradients of
    mean(logits^2)."""
    flax_model, variables, feats, lens = _setup()
    stats = variables["batch_stats"]
    mask = jax_padding_bias(jnp.asarray(lens), 8, 4)

    def forward(p):
        return flax_model.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(feats), jnp.asarray(lens), False,
                                mask=mask, in_len_div=4)

    logits = np.asarray(jax.jit(forward)(variables["params"]))
    grads = jax.jit(jax.grad(lambda p: jnp.mean(forward(p) ** 2)))(
        variables["params"])
    return logits, flatten_tree(jax.tree.map(np.asarray, grads))


@functools.cache
def _jax_pipeline_logits(shape, micro):
    """JAX's pipelined logits on a mesh of ``shape`` (pipe) or (data,
    pipe) virtual devices."""
    flax_model, variables, feats, lens = _setup()
    names = ("pipe",) if len(shape) == 1 else ("data", "pipe")
    devices = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    apply_fn = jax_pipeline(flax_model, Mesh(devices, names), micro,
                            in_len_div=4)
    batch = {"feats": jnp.asarray(feats), "inp_len": jnp.asarray(lens)}
    return np.asarray(jax.jit(
        lambda p: apply_fn(p, variables["batch_stats"], batch, False,
                           jax.random.PRNGKey(0))[0])(variables["params"]))


def _port_grads(rank, key):
    prefix = key + "/grad/"
    grads = {k[len(prefix):]: torch.from_numpy(v) for k, v in rank.items()
             if k.startswith(prefix)}
    return flatten_tree(convert.state_dict_to_flax(grads)["params"])


def _check_stages(ranks, stages, micro, remat):
    """Every rank's logits against the sequential model's and JAX's
    pipeline on ``stages`` devices; the gradients summed over the stages
    against the sequential model's."""
    seq_logits, seq_grads = _jax_sequential()
    pipe_logits = _jax_pipeline_logits((stages,), micro)
    key = "%d-%d" % (micro, remat)
    for rank in ranks:
        for want in (seq_logits, pipe_logits):
            np.testing.assert_allclose(rank[key + "/logits"], want,
                                       rtol=1e-4, atol=1e-5)
        got = _port_grads(rank, key)
        assert sorted(got) == sorted(seq_grads)
        for name, want in seq_grads.items():
            np.testing.assert_allclose(got[name], want, rtol=1e-3,
                                       atol=1e-5, err_msg=name)


@pytest.mark.parametrize("micro,remat", RUNS)
def test_two_stages_match_jax_and_the_sequential_stack(two_stages, micro,
                                                       remat):
    _check_stages(two_stages, 2, micro, remat)


@pytest.mark.parametrize("micro", [2, 4])
def test_four_stages_match_jax_and_the_sequential_stack(four_stages, micro):
    _check_stages(four_stages, 4, micro, False)


def test_pipeline_composes_with_data_parallel(tmp_path):
    ranks = _spawn(tmp_path, 2, 4, [(2, False)])
    want = _jax_pipeline_logits((2, 2), 2)
    _, seq_grads = _jax_sequential()
    for world_rank, rank in enumerate(ranks):
        data = world_rank // 2  # rank = data index x stages + stage
        np.testing.assert_allclose(rank["2-0/logits"],
                                   want[data * 4:(data + 1) * 4],
                                   rtol=1e-4, atol=1e-5)
        got = _port_grads(rank, "2-0")
        for name, grad in seq_grads.items():
            np.testing.assert_allclose(got[name], 2 * grad, rtol=1e-3,
                                       atol=2e-5, err_msg=name)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    from srf_tpu_torch.tools import save_tfrecord

    base = tmp_path_factory.mktemp("pipe_cli")
    _make_corpus(base)
    save_tfrecord.main(_argv(base, base / "unused"))
    return base


def test_trainer_tf_two_stages_equal_one_process(corpus, tmp_path):
    no_dropout = [flag for flag in STF_FLAGS if "dropout" not in flag] + [
        "--train-att-dropout=0", "--train-inn-dropout=0",
        "--train-inp-dropout=0", "--train-res-dropout=0",
        "--train-max-epoch=1"]
    single = tmp_path / "single"
    trainer_tf.main(_argv(corpus, single, *no_dropout))
    piped = tmp_path / "piped"
    outs = launch([sys.executable, "-m", "srf_tpu_torch.trainer_tf"]
                  + _argv(corpus, piped, *no_dropout,
                          "--tpu-pipeline-stages=2",
                          "--tpu-pipeline-microbatch=2")[1:])
    assert all("Pipeline parallelism: 2 stages x 1 data shards" in err
               for _, err in outs)
    want = checkpoint.CheckpointManager(str(single)).restore(1)
    got = checkpoint.CheckpointManager(str(piped)).restore(1)
    assert got["step"] == want["step"] == 5
    for key, value in want["model"].items():
        np.testing.assert_allclose(got["model"][key].numpy(), value.numpy(),
                                   rtol=0, atol=1e-5, err_msg=key)


def test_microbatches_bubble_and_stacked_blocks():
    assert [pipeline.divisor_at_most(b, 4) for b in (8, 6, 5, 3)] == [
        4, 3, 1, 3]
    assert pipeline.bubble(2, 4) == pytest.approx(0.2)
    flax_model, variables, _, _ = _setup()
    model = ConvEncoder(**MODEL)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    stacked = pipeline.stack_block_params(model.state_dict(), 4)
    want = jax_stack(variables["params"], 4)
    np.testing.assert_array_equal(stacked["ffn.ff1.weight"].numpy(),
                                  np.swapaxes(want["ffn"]["ff1"]["kernel"],
                                              1, 2))
    back = pipeline.unstack_block_params(stacked, 4)
    for key, value in back.items():
        assert torch.equal(value, model.state_dict()[key])
