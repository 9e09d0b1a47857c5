"""The ``model`` mesh axis in the port (``parallel/mesh.make_mesh(num_data,
num_model)``, ``parallel/sharding_rules.apply_rules``, the split SDR and
DR of ``ops/routing.py``, ``SDRTPFunction``) against JAX's ``apply_rules``
and its partitioned step.

Ranks are real OS processes over gloo on localhost
(``_torch_dist_worker.py``'s ``model_axis`` scenario), one launch of 2
ranks (a (data 1, model 2) mesh), one of 4 ((2, 2)) and one of 4 at
(1, 4) with SRF-WSJ's 32 classes (8 a rank) for the module:

- the rules, leaf by leaf against JAX's on the ``jax.eval_shape`` trees
  (``_torch_parity.random_flax_variables``): 63 classes (SRF-TIMIT's) at
  ``model`` 2 (nothing divides: all replicated) and 3 (the last W and b
  sharded), 32 (SRF-WSJ's) at ``model`` 2 and 4 (only the last layer),
  and the Adam moments shard-shaped after one step;
- the split SDR (1 and 2 iterations, the PAD mask on and off, its owner
  rank 0) and DR on 2 ranks against JAX's ``route_layer(impl="auto")`` on
  the whole W: each rank's output within 1e-5 of its slice, du and each
  rank's dW and db slice within 1e-4 of their largest entry;
- JAX's dry-run step (``__graft_entry__._dryrun_body``'s model: feat 16,
  8 classes, 3 layers; 32 at (1, 4)) with ``apply_rules(state, mesh)``
  on (1, 2), (2, 2) and (1, 4) virtual CPU meshes against the port's 2-
  and 4-rank steps,
  dropout off, at ``test_dp_step_matches_jax_mesh``'s limits;
- the traps: the global batch and metrics counted over ``data`` only,
  equal dropout seeds on the model ranks of one data index,
  ``broadcast_state`` over a shard, the replicated gradients bitwise
  equal on the model ranks, the sharded checkpoint in one process,
  gradient accumulation and EMA on shards, a mismatched world, and what
  ROADMAP item 7c brought to a shard (bf16 routing, the wavefront, the
  streaming ``route_block``; ``test_torch_sdr_tp_bf16.py`` and
  ``test_torch_model_axis_7c.py`` hold them to JAX).
"""

import json
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.ops import routing as jax_routing
from srf_tpu.parallel.mesh import make_mesh as jax_make_mesh
from srf_tpu.parallel.mesh import shard_batch as jax_shard_batch
from srf_tpu.parallel.sharding_rules import apply_rules as jax_apply_rules
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.ops import routing
from srf_tpu_torch.parallel import mesh as port_mesh
from srf_tpu_torch.parallel import sharding_rules
from srf_tpu_torch.train import optimizer as port_optimizer
from srf_tpu_torch.train import step
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_dist_worker import run_scenario
from _torch_parity import (flatten_tree, no_dropout, patch_out_jax_dropout,
                           random_flax_variables)

torch.set_num_threads(1)

# __graft_entry__.py:81-87, dropout off
MODEL = dict(
    feat_dim=16, class_n=8, enc_num=3, caps_primary_num=6,
    caps_primary_dim=4, caps_conv_num=5, caps_conv_dim=4, caps_class_dim=4,
    caps_iter=1, lpad=1, rpad=1, is_context=True, conv_layer_num=2,
    conv_filter_num=4, caps_type="naive", inp_dropout=0.0, inn_dropout=0.0,
)
OPTIMIZER = dict(
    train_opti_type=None, train_lr_param_k=0.05, model_dimension=1,
    train_warmup_n=4, train_lr_max=1e3, train_adam_beta1=0.9,
    train_adam_beta2=0.98, train_adam_epsilon=1e-9)
BATCH, FRAMES, IN_LEN_DIV = 8, 24, 4
# (SDR, PAD mask, iterations) of the split-routing cases
ROUTING = [(1, 1, 1), (1, 0, 1), (1, 1, 2), (1, 0, 2), (0, 1, 1), (0, 1, 2),
           (0, 0, 2)]
ROUTE_SHAPES = {"u": (2, 5, 6, 2), "W": (6, 4, 3, 2), "b": (6, 4, 3),
                "cot": (2, 5, 4, 3)}


def _batch():
    rng = np.random.RandomState(5)
    lens = np.array([24, 19, 22, 16, 24, 21, 12, 18], np.int32)
    tar_len = np.maximum(2, lens // 8).astype(np.int32)
    return {
        "feats": rng.randn(BATCH, FRAMES, MODEL["feat_dim"]).astype(
            np.float32),
        "labels": rng.randint(1, MODEL["class_n"] - 1,
                              size=(BATCH, tar_len.max())).astype(np.int32),
        "inp_len": lens, "tar_len": tar_len,
    }


def _route_inputs():
    rng = np.random.RandomState(11)
    scale = {"u": 1.0, "W": 0.5, "b": 0.1, "cot": 1.0}
    return {k: (scale[k] * rng.randn(*shape)).astype(np.float32)
            for k, shape in ROUTE_SHAPES.items()}


def _launch(tmp_path_factory, mesh, class_n=MODEL["class_n"]):
    workdir = tmp_path_factory.mktemp("model_axis_%dx%d" % tuple(mesh))
    model = dict(MODEL, class_n=class_n)
    variables = random_flax_variables(FlaxSequenceRouter(**model),
                                      MODEL["feat_dim"], seed=3)
    batch = _batch()
    state = convert.flax_to_state_dict(variables)
    two = mesh == (1, 2)
    spec = {"model": model, "optimizer": OPTIMIZER, "in_len_div": IN_LEN_DIV,
            "mesh": list(mesh), "routing": ROUTING if two else [],
            "accum": two}
    route = {"route/" + k: v for k, v in _route_inputs().items()}
    np.savez(workdir / "inputs.npz", spec=json.dumps(spec), **batch, **route,
             **{"sd/" + k: v.numpy() for k, v in state.items()})
    ranks = run_scenario("model_axis", workdir, ranks=mesh[0] * mesh[1])
    return types.SimpleNamespace(variables=variables, batch=batch,
                                 ranks=ranks, workdir=workdir, mesh=mesh,
                                 state=state, class_n=class_n)


@pytest.fixture(scope="module")
def runs2(tmp_path_factory):
    """The (data 1, model 2) launch: routing, steps and the traps."""
    return _launch(tmp_path_factory, (1, 2))


@pytest.fixture(scope="module")
def runs4(tmp_path_factory):
    """The (data 2, model 2) launch: the steps."""
    return _launch(tmp_path_factory, (2, 2))


@pytest.fixture(scope="module")
def runs14(tmp_path_factory):
    """The (data 1, model 4) launch at SRF-WSJ's 32 classes, 8 a rank:
    the steps."""
    return _launch(tmp_path_factory, (1, 4), class_n=32)


# ------------------------------------------------------------------ rules


def _jax_dims(shardings):
    """{leaf path: the dim sharded over 'model', or -1} of a tree of
    NamedShardings."""
    flat = {}
    for path, sharding in jax.tree_util.tree_flatten_with_path(
            shardings)[0]:
        spec = tuple(sharding.spec)
        name = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                        for k in path)
        flat[name] = spec.index("model") if "model" in spec else -1
    return flat


def _port_dims(model, specs):
    """{flax leaf path: the port's sharded dim, or -1}: each state_dict
    entry filled with its spec's code, mapped onto the flax tree by
    ``convert`` (a constant survives its transposes)."""
    codes = {k: torch.full(tuple(v.shape), float(-1 if specs.get(k) is None
                                                  else specs[k]))
             for k, v in model.state_dict().items()}
    return {k: int(np.unique(v)[0]) for k, v in flatten_tree(
        convert.state_dict_to_flax(codes)).items()}


@pytest.mark.parametrize("class_n,model_n,sharded", [
    (63, 2, False), (63, 3, True), (32, 2, True), (32, 4, True)])
def test_rules_match_jax_leaf_by_leaf(class_n, model_n, sharded):
    kwargs = dict(MODEL, class_n=class_n, enc_num=3)
    variables = random_flax_variables(FlaxSequenceRouter(**kwargs),
                                      kwargs["feat_dim"], seed=1)
    jax_mesh = jax_make_mesh(num_data=1, num_model=model_n,
                             devices=jax.devices()[:model_n])
    want = _jax_dims(jax_apply_rules(variables, jax_mesh))
    model = SequenceRouter(**kwargs)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    whole = {k: tuple(p.shape) for k, p in model.named_parameters()}
    specs = sharding_rules.apply_rules(
        model, port_mesh.Mesh({"data": 1, "model": model_n}))
    assert sorted(specs) == sorted(whole)
    assert _port_dims(model, specs) == want
    got = {k for k, v in want.items() if v >= 0}
    assert got == ({"params/W2", "params/b2"} if sharded else set())
    # the shards: this rank's (index 0) contiguous slice of the out capsules
    for name, dim in specs.items():
        param = dict(model.named_parameters())[name]
        if dim is None:
            assert tuple(param.shape) == whole[name]
            continue
        assert param.is_contiguous()
        assert param.shape[dim] == whole[name][dim] // model_n
        np.testing.assert_array_equal(
            param.detach().numpy(),
            np.take(variables["params"][name],
                    range(whole[name][dim] // model_n), axis=dim))


@pytest.mark.parametrize("class_n,model_n", [(63, 2), (63, 3), (32, 2),
                                             (32, 4)])
def test_adam_moments_are_shard_shaped_after_a_step(class_n, model_n):
    """JAX's rules on the TrainState shard mu and nu as their parameters;
    the port's Adam, built after apply_rules, makes shard-shaped moments."""
    kwargs = dict(MODEL, class_n=class_n)
    variables = random_flax_variables(FlaxSequenceRouter(**kwargs),
                                      kwargs["feat_dim"], seed=1)
    tx, _ = jax_optimizer.get_optimizer(types.SimpleNamespace(**OPTIMIZER))
    jax_state = JaxTrainState.create(variables["params"], tx,
                                     variables["batch_stats"])
    jax_mesh = jax_make_mesh(num_data=1, num_model=model_n,
                             devices=jax.devices()[:model_n])
    dims = _jax_dims(jax_apply_rules(jax_state, jax_mesh))
    moments = {k: v for k, v in dims.items() if "/mu/" in k or "/nu/" in k}
    assert moments
    model = SequenceRouter(**kwargs)
    model.load_state_dict(convert.flax_to_state_dict(variables))
    specs = sharding_rules.apply_rules(
        model, port_mesh.Mesh({"data": 1, "model": model_n}))
    opt, _ = port_optimizer.get_optimizer(types.SimpleNamespace(**OPTIMIZER),
                                          model.parameters())
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    for name, p in model.named_parameters():
        for kind in ("mu", "nu"):
            path = [k for k in moments if k.endswith("/%s/%s" % (kind, name))]
            if path:  # the routing leaves keep their flax names
                want = moments[path[0]]
                assert want == (-1 if specs[name] is None else specs[name])
        for key in ("exp_avg", "exp_avg_sq"):
            assert opt.state[p][key].shape == p.shape


# ---------------------------------------------------------------- routing


@pytest.mark.parametrize("case", ROUTING, ids=lambda c: "%s-pad%d-iter%d" % (
    "sdr" if c[0] else "dr", c[1], c[2]))
def test_split_routing_matches_jax_route_layer(runs2, case):
    """Each rank's split routing against JAX's ``route_layer`` (auto) on
    the whole W and b: its output slice, the whole du (summed over the
    ranks) and its dW and db slices."""
    is_context, is_last, num_iter = case
    arrays = _route_inputs()
    u, wgt, bias, cot = (jnp.asarray(arrays[k]) for k in ("u", "W", "b",
                                                          "cot"))

    def loss(u, wgt, bias):
        out = jax_routing.route_layer(u, wgt, bias, num_iter,
                                      bool(is_context), bool(is_last),
                                      impl="auto")
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                         has_aux=True)(u, wgt, bias)
    out, (du, dwgt, dbias) = np.asarray(out), map(np.asarray, grads)
    key = "route/%d%d%d/" % case
    length = wgt.shape[1] // 2
    for rank in runs2.ranks:
        assert rank["route/group_size"] == 2
        index = rank["mesh/index"][1]
        part = slice(index * length, (index + 1) * length)
        np.testing.assert_allclose(rank[key + "out"], out[:, :, part],
                                   rtol=0, atol=1e-5)
        for name, want in (("du", du), ("dW", dwgt[:, part]),
                           ("db", dbias[:, part])):
            np.testing.assert_allclose(rank[key + name], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=name)


def test_kernel_exchanges_gather_and_sum_over_the_model_group(runs2):
    """K1-tp's all-gather of the rows' (m, l) pairs ([ranks, rows, 2] in
    rank order) and K2-tp's SUM all-reduce, over gloo."""
    rows = [[[float(q), 1.0 + n] for n in range(3)] for q in range(2)]
    for rank in runs2.ranks:
        np.testing.assert_array_equal(rank["exchange/pairs"], rows)
        np.testing.assert_array_equal(rank["exchange/sum"],
                                      np.sum(rows, axis=0))


# ------------------------------------------------------------------- step


def _jax_run(variables, batch, mesh_shape, steps=2,
             class_n=MODEL["class_n"]):
    """JAX's dry-run step with ``apply_rules(state, mesh)`` on a (data,
    model) mesh of virtual CPU devices: metrics per step, the gradients of
    the first step's loss (unsharded: the partitioned step's values) and
    the final params and batch_stats, flat."""
    num_data, num_model = mesh_shape
    mesh = jax_make_mesh(num_data=num_data, num_model=num_model,
                         devices=jax.devices()[:num_data * num_model])
    flax_model = FlaxSequenceRouter(**dict(MODEL, class_n=class_n))
    tx, _ = jax_optimizer.get_optimizer(types.SimpleNamespace(**OPTIMIZER))
    apply_fn = jax_step.make_apply_fn(flax_model)
    params = jax.tree.map(jnp.asarray, variables["params"])
    stats = jax.tree.map(jnp.asarray, variables["batch_stats"])
    state = JaxTrainState.create(params, tx, stats)
    sharding = jax_apply_rules(state, mesh)
    train = jax_step.make_train_step(apply_fn, tx, IN_LEN_DIV, mesh=mesh,
                                     donate=False, state_sharding=sharding)
    state = jax.device_put(state, sharding)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        from srf_tpu.ops.ctc import ctc_loss_from_frames

        logits, _ = apply_fn(p, stats, jbatch, True, jax.random.PRNGKey(0))
        pe = ctc_loss_from_frames(logits, jbatch["inp_len"], IN_LEN_DIV,
                                  jbatch["labels"], jbatch["tar_len"])
        return jnp.sum(pe) / batch["feats"].shape[0]

    grads = flatten_tree(jax.tree.map(np.asarray,
                                      jax.jit(jax.grad(loss))(params)))
    sharded = jax_shard_batch(mesh, jbatch)
    metrics = []
    for i in range(steps):
        state, m = train(state, sharded, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    final = flatten_tree(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))
    return metrics, grads, final


def _port_flat(rank, prefix):
    tensors = {k[len(prefix):]: torch.from_numpy(v) for k, v in rank.items()
               if k.startswith(prefix)}
    return flatten_tree(convert.state_dict_to_flax(tensors))


@pytest.mark.parametrize("mesh_shape", [(1, 2), (2, 2), (1, 4)])
def test_step_matches_jax_apply_rules_step(monkeypatch, request,
                                           mesh_shape):
    patch_out_jax_dropout(monkeypatch)
    runs = request.getfixturevalue(
        {(1, 2): "runs2", (2, 2): "runs4", (1, 4): "runs14"}[mesh_shape])
    metrics, grads, final = _jax_run(runs.variables, runs.batch, mesh_shape,
                                     class_n=runs.class_n)
    for rank in runs.ranks:
        for i, want in enumerate(metrics):
            np.testing.assert_allclose(rank["step/metrics/%d/loss_sum" % i],
                                       want["loss_sum"], rtol=1e-5)
            for key in ("samples", "frames"):
                assert rank["step/metrics/%d/%s" % (i, key)] == want[key]
        got = _port_flat(rank, "step/grad/")
        got = {k[len("params/"):]: v for k, v in got.items()}
        assert sorted(got) == sorted(grads)
        for key, want in grads.items():
            np.testing.assert_allclose(got[key], want, rtol=0,
                                       atol=1e-4 * np.abs(want).max(),
                                       err_msg=key)
        state = _port_flat(rank, "step/state/")
        assert sorted(state) == sorted(final)
        for key, want in final.items():
            if key.startswith("batch_stats"):
                np.testing.assert_allclose(state[key], want, rtol=0,
                                           atol=1e-6, err_msg=key)
            else:
                np.testing.assert_allclose(state[key], want, rtol=1e-4,
                                           atol=1e-6, err_msg=key)


# ------------------------------------------------------------------ traps


def test_global_batch_and_metrics_count_the_data_axis_only(runs2, runs4):
    """Both model ranks hold the same 8 rows (or 4 of them a data index):
    a reduction over the world would count them twice."""
    frames = float(runs2.batch["inp_len"].sum())
    for runs in (runs2, runs4):
        for rank in runs.ranks:
            assert rank["step/metrics/0/samples"] == BATCH
            assert rank["step/metrics/0/frames"] == frames
            assert rank["valid/samples"] == BATCH
        losses = {float(r["step/metrics/0/loss_sum"]) for r in runs.ranks}
        assert len(losses) == 1


def test_dropout_seed_is_the_data_index_s(runs4):
    seeds = {tuple(r["mesh/index"]): int(r["seed"]) for r in runs4.ranks}
    assert seeds[(0, 0)] == seeds[(0, 1)] == step.step_seed(1234, 0, 0)
    assert seeds[(1, 0)] == seeds[(1, 1)] == step.step_seed(1234, 0, 1)
    assert seeds[(0, 0)] != seeds[(1, 0)]
    # and the mesh: global rank = data index x num_model + model index
    for r, rank in enumerate(runs4.ranks):
        assert tuple(rank["mesh/index"]) == divmod(r, 2)
        assert tuple(rank["mesh/sizes"]) == (2, 2)


def test_broadcast_state_leaves_each_shard_its_own(runs2):
    """Rank 1 moved every weight by +1 before ``broadcast_state``: its
    replicated weights become rank 0's, its shard stays its own."""
    rank0, rank1 = runs2.ranks
    whole = runs2.state
    for name, value in whole.items():
        key = "bcast/" + name
        if key not in rank1:
            continue  # buffers
        if name in ("W2", "b2"):
            np.testing.assert_array_equal(rank1[key],
                                          value.numpy()[:, 4:] + 1.0)
            np.testing.assert_array_equal(rank0[key], value.numpy()[:, :4])
        else:
            np.testing.assert_array_equal(rank1[key], rank0[key])
            np.testing.assert_array_equal(rank1[key], value.numpy())


def test_replicated_gradients_are_bitwise_equal_on_the_model_ranks(runs2,
                                                                   runs4):
    for runs in (runs2, runs4):
        by_data = {}
        for rank in runs.ranks:
            by_data.setdefault(int(rank["mesh/index"][0]), []).append(rank)
        for first, second in by_data.values():
            names = [k for k in first if k.startswith("step/local_grad/")]
            assert names
            for key in names:
                if key.endswith(("/W2", "/b2")):
                    assert not np.array_equal(first[key], second[key])
                else:
                    np.testing.assert_array_equal(first[key], second[key],
                                                  err_msg=key)


def test_sharded_checkpoint_serves_in_one_process(runs2):
    """rank 0's checkpoint of the 2-rank state holds whole tensors (the
    shards and their Adam moments gathered) and, loaded into one process,
    gives the ranks' eval logits."""
    tree = CheckpointManager(str(runs2.workdir / "ckpt")).restore(2)
    model = SequenceRouter(**MODEL)
    model.load_state_dict(tree["model"])  # strict: whole shapes
    for name, value in tree["model"].items():
        np.testing.assert_array_equal(
            value.numpy(), runs2.ranks[0]["step/state/" + name], err_msg=name)
    shapes = [tuple(p.shape) for p in model.parameters()]
    moments = tree["optimizer"]["state"]
    assert [tuple(moments[i]["exp_avg"].shape) for i in range(len(shapes))
            ] == shapes
    apply_fn = step.make_apply_fn(model)
    batch = {k: torch.from_numpy(v) for k, v in runs2.batch.items()}
    with torch.no_grad():
        logits = apply_fn(batch, False).numpy()
    for rank in runs2.ranks:
        np.testing.assert_allclose(rank["logits"], logits, rtol=0, atol=1e-5)
    # and restore_into slices it back into a sharded state
    from srf_tpu_torch.utils.checkpoint import restore_into

    sharded = SequenceRouter(**MODEL)
    sharding_rules.apply_rules(
        sharded, port_mesh.Mesh({"data": 1, "model": 2}))
    opt, scheduler = port_optimizer.get_optimizer(
        types.SimpleNamespace(**OPTIMIZER), sharded.parameters())
    state = TrainState.create(sharded, opt, scheduler, device="cpu")
    restore_into(state, tree)
    np.testing.assert_array_equal(sharded.W2.detach().numpy(),
                                  tree["model"]["W2"].numpy()[:, :4])
    index = [n for n, _ in sharded.named_parameters()].index("W2")
    assert opt.state_dict()["state"][index]["exp_avg"].shape == (15, 4, 4, 4)


def test_grad_accum_and_ema_work_on_shards(runs2):
    """accum 2 and EMA 0.9 on the 2-rank sharded state against the same
    step in one process (itself held to JAX's in test_torch_train_extras)."""
    model = no_dropout(SequenceRouter(**MODEL))
    model.load_state_dict(runs2.state)
    opt, scheduler = port_optimizer.get_optimizer(
        types.SimpleNamespace(**OPTIMIZER), model.parameters())
    state = TrainState.create(model, opt, scheduler, with_ema=True,
                              device="cpu")
    train_step = step.make_train_step(step.make_apply_fn(model), IN_LEN_DIV,
                                      accum_steps=2, ema_decay=0.9)
    batch = {k: torch.from_numpy(v) for k, v in runs2.batch.items()}
    state, metrics = train_step(state, batch, 1234)
    for rank in runs2.ranks:
        np.testing.assert_allclose(rank["accum/loss_sum"],
                                   metrics["loss_sum"].item(), rtol=1e-5)
        for prefix, want in (("accum/state/", model.state_dict()),
                             ("accum/ema/", state.ema)):
            for name, value in want.items():
                np.testing.assert_allclose(rank[prefix + name],
                                           value.detach().numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=prefix + name)


def test_make_mesh_raises_on_a_mismatched_world():
    with pytest.raises(ValueError, match="launch 2 processes"):
        port_mesh.make_mesh(1, num_model=2, device="cpu")
    with pytest.raises(ValueError, match="launch 4 processes"):
        port_mesh.make_mesh(-1, num_model=4, device="cpu")
    with pytest.raises(ValueError, match="num_model"):
        port_mesh.make_mesh(1, num_model=0, device="cpu")


def test_what_a_shard_does_not_reach_raises_naming_item_7c(runs2, runs4):
    """What a shard did not reach before ROADMAP item 7c now runs there:
    on every rank of both meshes the sharded model's bf16-routing forward
    (within 5e-2 of the float32 logits, and off them), its wavefront
    forward (the layered logits within test_torch_wavefront.py's 2e-5)
    and its streaming ``route_block`` with a carry and a warm-up step
    (whole: the ranks' capsules gathered), equal on the model ranks; and
    ``route_layer(..., bf16=True, shard=...)`` in one process. FSDP on a
    ``model`` axis is still refused, as in JAX."""
    for run in (runs2, runs4):
        for rank in run.ranks:
            logits = rank["7c/logits"]
            assert np.isfinite(rank["7c/bf16_logits"]).all()
            np.testing.assert_allclose(rank["7c/bf16_logits"], logits,
                                       atol=5e-2 * np.abs(logits).max())
            assert np.abs(rank["7c/bf16_logits"] - logits).max() > 1e-6
            np.testing.assert_allclose(rank["7c/wavefront_logits"], logits,
                                       rtol=0, atol=2e-5)
            assert rank["7c/route_block"].shape[2] == MODEL["class_n"]
            assert rank["7c/v_last"].shape[1] == MODEL["class_n"]
            assert not rank["7c/route_block"][:, 0].any()
            # the model ranks of one data index hold the same batch
            peer = next(r for r in run.ranks if r["mesh/index"][0]
                        == rank["mesh/index"][0])
            for key in ("7c/bf16_logits", "7c/wavefront_logits",
                        "7c/route_block"):
                np.testing.assert_array_equal(rank[key], peer[key], key)
    model = SequenceRouter(**MODEL)
    sharding_rules.apply_rules(model, port_mesh.Mesh({"data": 1, "model": 2}))
    assert model.W2.shape[1] == MODEL["class_n"] // 2
    u = torch.randn(1, 2, 15, 4)
    out = routing.route_layer(u, model.W2, model.b2, 1, True, True,
                              bf16=True, shard=(0, 8, None))
    assert out.shape == (1, 2, 4, 4) and out.dtype == torch.float32
    with pytest.raises(ValueError, match="fsdp"):
        sharding_rules.fsdp(model, port_mesh.Mesh({"data": 1, "model": 2}))
