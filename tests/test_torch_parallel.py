"""Data parallelism and FSDP in the port (``train/step.py`` with a group,
``parallel/{mesh,sharding_rules}.py``) against JAX's mesh step.

Two ranks are real OS processes over gloo on localhost
(``_torch_dist_worker.py``, one spawn for every 2-rank check here, one
of 4 ranks for the DP and FSDP steps at world size 4). A small SRF
(L=3, 8 filters, BatchNorm in its front end) with dropout off (flax's
``Dropout`` patched to the identity, the port's rates 0: F6) trains on a
global batch of 8 utterances, 4 a rank:

- the 2-rank step against ``srf_tpu.train.step.make_train_step`` on a
  2-device mesh and on one device, and the 4-rank step on a 4-device
  mesh: the global ``loss_sum``, ``samples``
  and ``frames`` (rtol 1e-5), every gradient of step 1 (1e-4 of its
  largest entry, ``test_torch_train.py``'s limit), the parameters after
  step 2 (atol 1e-6, rtol 1e-4) and the BatchNorm running statistics
  (the same bits on both ranks; within 1e-6 of JAX's);
- ``--tpu-grad-accum`` 2 under DP: microbatch i is each rank's local
  slice i, which with the global BatchNorm is JAX's accumulated step on
  the global batch permuted to [r0 mb0, r1 mb0, r0 mb1, r1 mb1];
- FSDP (2 and 4 ranks) against DP, with JAX's
  ``test_fsdp_matches_replicated`` limits (loss rtol 1e-4, parameters rtol 1e-3 / atol 1e-6); its
  checkpoint (whole tensors from rank 0) loads into one process and
  equals the DP state;
- ``--tpu-bf16`` under FSDP (FSDP's mixed precision) against the
  unsharded bf16 step;
- one MWER update on 2 ranks (each rank's own n-best) against the
  one-process update on the 8 rows;
- the valid step's metrics summed over the ranks.

And, in this process: F22 (the dropout seed folds in the rank), F23 (k of
the local batch), the mesh's errors (and the 2 ranks' (data 1, model 2)
mesh), global BatchNorm in one process.
"""

import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srf_tpu.parallel.mesh import shard_batch as jax_shard_batch
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.models import layers
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.parallel import mesh as port_mesh
from srf_tpu_torch.train import step
from srf_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_dist_worker import run_scenario
from _torch_parity import flatten_tree, patch_out_jax_dropout, random_flax_variables

torch.set_num_threads(1)

FEAT_DIM, CLASS_N, IN_LEN_DIV, BATCH = 20, 11, 4, 8
MODEL = dict(
    feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=3, caps_primary_num=8,
    caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4, caps_class_dim=4,
    caps_iter=1, lpad=1, rpad=1, is_context=True, conv_layer_num=2,
    conv_filter_num=8, caps_type="naive", inp_dropout=0.0, inn_dropout=0.0,
)
OPTIMIZER = dict(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=1,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)


def _batch():
    rng = np.random.RandomState(5)
    lens = np.array([24, 19, 22, 16, 24, 21, 12, 18], np.int32)
    tar_len = np.maximum(2, lens // 8).astype(np.int32)
    return {
        "feats": rng.randn(BATCH, 24, FEAT_DIM).astype(np.float32),
        "labels": rng.randint(1, CLASS_N - 1, size=(BATCH, tar_len.max())
                              ).astype(np.int32),
        "inp_len": lens, "tar_len": tar_len,
    }


def _spawn(workdir, ranks, **spec):
    """The flax variables, the batch, and every rank's results of the
    worker's ``dp`` scenario on ``ranks`` ranks (one spawn)."""
    import json

    variables = random_flax_variables(FlaxSequenceRouter(**MODEL),
                                      FEAT_DIM, seed=3)
    batch = _batch()
    state = convert.flax_to_state_dict(variables)
    spec = dict(spec, model=MODEL, optimizer=OPTIMIZER,
                in_len_div=IN_LEN_DIV)
    np.savez(workdir / "inputs.npz", spec=json.dumps(spec), **batch,
             **{"sd/" + k: v.numpy() for k, v in state.items()})
    ranks = run_scenario("dp", workdir, ranks=ranks)
    return types.SimpleNamespace(variables=variables, batch=batch,
                                 ranks=ranks, workdir=workdir)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' results of the ``dp`` scenario on 2 ranks."""
    return _spawn(tmp_path_factory.mktemp("dp"), 2)


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    """The DP and FSDP steps on 4 ranks (2 rows a rank)."""
    return _spawn(tmp_path_factory.mktemp("dp4"), 4, runs=["dp", "fsdp"])


def _jax_run(variables, batch, steps, mesh=None, accum=1):
    """JAX's train step on ``batch``: (metrics per step, gradients of the
    first step's loss, final params + batch_stats as flat numpy)."""
    flax_model = FlaxSequenceRouter(**MODEL)
    tx, _ = jax_optimizer.get_optimizer(types.SimpleNamespace(**OPTIMIZER))
    apply_fn = jax_step.make_apply_fn(flax_model)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = JaxTrainState.create(params, tx, stats)
    train = jax_step.make_train_step(apply_fn, tx, IN_LEN_DIV, mesh=mesh,
                                     donate=False, accum_steps=accum)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    if mesh is not None:
        jbatch = jax_shard_batch(mesh, jbatch)

    def loss(p):
        logits, _ = apply_fn(p, stats, jbatch, True, jax.random.PRNGKey(0))
        from srf_tpu.ops.ctc import ctc_loss_from_frames

        pe = ctc_loss_from_frames(logits, jbatch["inp_len"], IN_LEN_DIV,
                                  jbatch["labels"], jbatch["tar_len"])
        return jnp.sum(pe) / batch["feats"].shape[0]

    grads = (flatten_tree(jax.tree.map(np.asarray, jax.jit(jax.grad(loss))(
        params))) if accum == 1 else None)
    metrics = []
    for i in range(steps):
        state, m = train(state, jbatch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    final = flatten_tree(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    return metrics, grads, final


def _port_tree(ranks, label):
    """Rank 0's state of ``label`` as a flat flax tree, after checking every
    rank holds the same bits."""
    prefix = label + "/state/"
    state = {k[len(prefix):]: v for k, v in ranks[0].items()
             if k.startswith(prefix)}
    for key, value in state.items():
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[prefix + key], value,
                                          err_msg=key)
    return flatten_tree(convert.state_dict_to_flax(
        {k: torch.from_numpy(v) for k, v in state.items()}))


def _port_grads(ranks, label):
    prefix = label + "/grad/"
    grads = {k[len(prefix):]: torch.from_numpy(v)
             for k, v in ranks[0].items() if k.startswith(prefix)}
    return flatten_tree(convert.state_dict_to_flax(grads)["params"])


def _check_state(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        if key.startswith("batch_stats"):
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                       atol=1e-6, err_msg=key)


@pytest.mark.parametrize("devices", [2, 1, 4])
def test_dp_step_matches_jax_mesh(monkeypatch, request, devices):
    """The 2-rank step against JAX's on a mesh of ``devices`` (1 or 2), and
    the 4-rank step against JAX's on 4 devices."""
    runs = request.getfixturevalue("runs4" if devices == 4 else "runs")
    patch_out_jax_dropout(monkeypatch)
    mesh = (jax_make_mesh(num_data=devices, devices=jax.devices()[:devices])
            if devices > 1 else None)
    metrics, grads, final = _jax_run(runs.variables, runs.batch, 2, mesh)
    for rank in runs.ranks:
        for i, want in enumerate(metrics):
            np.testing.assert_allclose(rank["dp/metrics/%d/loss_sum" % i],
                                       want["loss_sum"], rtol=1e-5)
            for key in ("samples", "frames"):
                assert rank["dp/metrics/%d/%s" % (i, key)] == want[key]
    got = _port_grads(runs.ranks, "dp")
    assert sorted(got) == sorted(grads)
    for key, want in grads.items():
        np.testing.assert_allclose(got[key], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max(),
                                   err_msg=key)
    _check_state(_port_tree(runs.ranks, "dp"), final)


def test_grad_accum_under_dp_is_jax_on_the_permuted_batch(monkeypatch,
                                                          runs):
    patch_out_jax_dropout(monkeypatch)
    # rank r's rows are 4r .. 4r+3; its microbatch i is 2 of them
    order = [0, 1, 4, 5, 2, 3, 6, 7]
    permuted = {k: v[order] for k, v in runs.batch.items()}
    metrics, _, final = _jax_run(runs.variables, permuted, 1, accum=2)
    for rank in runs.ranks:
        np.testing.assert_allclose(rank["accum/metrics/0/loss_sum"],
                                   metrics[0]["loss_sum"], rtol=1e-5)
    _check_state(_port_tree(runs.ranks, "accum"), final)


def _check_fsdp_matches_dp(runs):
    """JAX's ``test_fsdp_matches_replicated`` limits: the loss of each step
    (rtol 1e-4) and the parameters after two (rtol 1e-3, atol 1e-6)."""
    for rank in runs.ranks:
        for i in range(2):
            np.testing.assert_allclose(
                rank["fsdp/metrics/%d/loss_sum" % i],
                rank["dp/metrics/%d/loss_sum" % i], rtol=1e-4)
    fsdp, dp = _port_tree(runs.ranks, "fsdp"), _port_tree(runs.ranks, "dp")
    for key in dp:
        np.testing.assert_allclose(fsdp[key], dp[key], rtol=1e-3, atol=1e-6,
                                   err_msg=key)
    return dp


def test_fsdp_matches_dp_and_its_checkpoint_loads_in_one_process(runs):
    dp = _check_fsdp_matches_dp(runs)
    tree = CheckpointManager(str(runs.workdir / "fsdp_ckpt")).restore(2)
    model = SequenceRouter(**MODEL)
    model.load_state_dict(tree["model"])  # one process, whole tensors
    saved = flatten_tree(convert.state_dict_to_flax(model.state_dict()))
    for key in dp:
        np.testing.assert_allclose(saved[key], dp[key], rtol=1e-3, atol=1e-6,
                                   err_msg=key)
    # Adam's moments saved whole, keyed by parameter index as in one process
    moments = tree["optimizer"]["state"]
    shapes = [p.shape for p in model.parameters()]
    assert sorted(moments) == list(range(len(shapes)))
    for index, shape in enumerate(shapes):
        assert moments[index]["exp_avg"].shape == shape


def test_fsdp_matches_dp_on_4_ranks(runs4):
    """FSDP's shards of 4 ranks (each parameter in 4 chunks, the smallest
    padded) against DP on the same 4 ranks."""
    _check_fsdp_matches_dp(runs4)


def test_fsdp_composes_with_bf16(runs):
    """``--tpu-fsdp --tpu-bf16``: FSDP's mixed precision all-gathers bf16
    copies of the masters, the bf16 forward of the unsharded step; the
    loss and gradients agree (only the gradients' reduction order
    differs)."""
    for rank in runs.ranks:
        np.testing.assert_allclose(rank["fsdp_bf16/metrics/0/loss_sum"],
                                   rank["dp_bf16/metrics/0/loss_sum"],
                                   rtol=1e-5)
        assert rank["dp_bf16/metrics/0/loss_sum"] != rank[
            "dp/metrics/0/loss_sum"]  # bf16 rounds where float32 does not
    got, want = _port_grads(runs.ranks, "fsdp_bf16"), _port_grads(
        runs.ranks, "dp_bf16")
    for key, grad in want.items():
        np.testing.assert_allclose(got[key], grad, rtol=0,
                                   atol=1e-4 * np.abs(grad).max(),
                                   err_msg=key)


def test_mwer_under_dp_is_the_one_process_update(runs):
    """MWER on 2 ranks (each decodes its own rows' n-best, both loss terms
    over the global batch, gradients summed) against the one-process
    update on the 8 rows (itself held to JAX's in test_torch_mwer.py)."""
    from srf_tpu_torch.train import mwer, optimizer as port_optimizer
    from srf_tpu_torch.train.state import TrainState

    model = SequenceRouter(**MODEL)
    model.load_state_dict(convert.flax_to_state_dict(runs.variables))
    for module in model.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0
    opt, scheduler = port_optimizer.get_optimizer(
        types.SimpleNamespace(**OPTIMIZER), model.parameters())
    state = TrainState.create(model, opt, scheduler, device="cpu")
    apply_fn = step.make_apply_fn(model)
    train_step = mwer.make_mwer_train_step(
        apply_fn, step.make_logits_fn(apply_fn), IN_LEN_DIV, beam_width=8,
        n_best=3, blank_id=CLASS_N - 1)
    _, metrics = train_step(state, {k: torch.from_numpy(v) for k, v in
                                    runs.batch.items()}, 3)
    for rank in runs.ranks:
        np.testing.assert_allclose(rank["mwer/metrics/0/loss_sum"],
                                   metrics["loss_sum"].item(), rtol=1e-5)
        assert rank["mwer/metrics/0/samples"] == BATCH
    want = flatten_tree(convert.state_dict_to_flax(
        {k: p.grad for k, p in model.named_parameters()})["params"])
    got = _port_grads(runs.ranks, "mwer")
    for key, grad in want.items():
        np.testing.assert_allclose(got[key], grad, rtol=0,
                                   atol=1e-4 * np.abs(grad).max(),
                                   err_msg=key)


def test_valid_step_sums_over_the_ranks(runs):
    samples = [r["valid/samples"] for r in runs.ranks]
    assert samples == [BATCH, BATCH]
    assert runs.ranks[0]["valid/loss_sum"] == runs.ranks[1]["valid/loss_sum"]


def test_f22_the_dropout_seed_folds_in_the_rank():
    seeds = [step.step_seed(1234, 7, rank) for rank in range(4)]
    assert seeds[0] == step.step_seed(1234, 7)  # one process's
    assert len(set(seeds)) == 4


def test_f23_accumulation_divides_the_local_batch():
    """k is the largest divisor of the *local* batch at most the flag;
    JAX's divides the global batch, so 2 ranks of 3 rows at flag 2 take one
    microbatch where JAX takes 2 of the 6 global rows."""
    local = {"feats": np.zeros((3, 4, 2)), "inp_len": np.ones(3)}
    assert len(step.microbatches(local, 2)) == 1
    jax_k = 2
    while 6 % jax_k:
        jax_k -= 1
    assert jax_k == 2
    assert len(step.microbatches({"feats": np.zeros((4, 4, 2))}, 2)) == 2


def test_mesh_needs_one_process_per_card(runs):
    mesh = port_mesh.make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    assert mesh.group() is None and mesh.index() == 0
    with pytest.raises(ValueError, match="launch 2 processes"):
        port_mesh.make_mesh(2, device="cpu")
    # the 2 ranks build a (data 1, model 2) mesh: rank r is model index r
    for r, rank in enumerate(runs.ranks):
        assert list(rank["model_mesh/shape"]) == [1, 2]
        assert list(rank["model_mesh/index"]) == [0, r]
        assert list(rank["model_mesh/sizes"]) == [1, 2]
    with pytest.raises(ValueError, match="launch 2 processes"):
        port_mesh.make_pipeline_mesh(2, device="cpu")


def test_batch_norm_of_a_one_rank_group_is_the_local_one():
    """A group of one rank normalises with this process's statistics: the
    same bits as no group (the world-size-1 step equals the plain one)."""
    torch.manual_seed(0)
    x = torch.randn(3, 4, 5, 6)
    plain, grouped = (torch.nn.BatchNorm2d(4, eps=1e-3).train()
                      for _ in range(2))
    grouped.process_group = object()  # never reached: world size 1
    assert layers._group(grouped) is None
    assert torch.equal(layers.batch_norm(x, plain),
                       layers.batch_norm(x, grouped))
