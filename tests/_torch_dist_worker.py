"""One rank of the port's multi-process tests, and the launcher that starts
the ranks (real OS processes over gloo on a localhost port).

    python tests/_torch_dist_worker.py SCENARIO WORKDIR

with ``SRF_COORDINATOR``, ``SRF_NUM_PROCESSES`` and ``SRF_PROCESS_ID`` set
(``launch`` sets them). Each scenario reads ``WORKDIR/inputs.npz`` (the
test writes the weights as a state_dict, the batch and a JSON ``spec``),
runs on the CPU and writes ``WORKDIR/<scenario>-rank<r>.npz``. It imports
torch and srf_tpu_torch only.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch(command, ranks=2, expect_rc=0, timeout=240, env=None):
    """Run ``command`` (argv) as ``ranks`` processes of one gloo world;
    assert each exits ``expect_rc``; return their (stdout, stderr)."""
    port = free_port()
    procs = []
    for rank in range(ranks):
        proc_env = dict(os.environ, SRF_COORDINATOR="127.0.0.1:%d" % port,
                        SRF_NUM_PROCESSES=str(ranks),
                        SRF_PROCESS_ID=str(rank), OMP_NUM_THREADS="1",
                        PYTHONPATH=REPO + os.pathsep
                        + os.environ.get("PYTHONPATH", ""))
        proc_env.update(env or {})
        procs.append(subprocess.Popen(
            command, env=proc_env, cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    outputs = []
    try:
        for proc in procs:
            outputs.append(proc.communicate(timeout=timeout))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    for rank, (proc, (_, err)) in enumerate(zip(procs, outputs)):
        assert proc.returncode == expect_rc, (rank, proc.returncode,
                                              err[-4000:])
    return outputs


# Elastic resume (JAX's tests/test_elastic.py, a job resumed on a resized
# mesh; here the mesh's data axis is the process count): each scenario is a
# sequence of runs of the trainer CLI on one checkpoint directory, as
# (processes, flags, exit code), and the uninterrupted run it is held to.
# Batch sharding keeps the one-process schedule of the global batches, so
# a batch index names the same data position on any world size
ELASTIC_FLAGS = ("--tpu-data-shard=batch",)
ELASTIC = {
    # killed mid-epoch on 2 ranks (the last mid checkpoint at epoch 2's
    # batch 2, global step 7), resumed mid-epoch by one process
    "mid_2_to_1": {
        "runs": ((2, ("--train-max-epoch=2", "--tpu-ckpt-every-steps=2",
                      "--tpu-fault-at-step=8"), 42),
                 (1, ("--train-max-epoch=2", "--tpu-ckpt-every-steps=2"), 0)),
        "reference": (2, ("--train-max-epoch=2",)),
    },
    # epoch 1 on one process, epoch 2 on 2 ranks from its checkpoint
    "epoch_1_to_2": {
        "runs": ((1, ("--train-max-epoch=1",), 0),
                 (2, ("--train-max-epoch=2",), 0)),
        "reference": (1, ("--train-max-epoch=2",)),
    },
}


def run_trainer(command, ranks, expect_rc=0, timeout=240):
    """``command`` (argv) as one plain process (``ranks`` 1) or as
    ``ranks`` processes of one gloo world; returns each process's (stdout,
    stderr)."""
    if ranks > 1:
        return launch(command, ranks=ranks, expect_rc=expect_rc,
                      timeout=timeout)
    env = {k: v for k, v in os.environ.items() if not k.startswith("SRF_")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(command, env=env, cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == expect_rc, (proc.returncode,
                                          proc.stderr[-4000:])
    return [(proc.stdout, proc.stderr)]


def run_elastic(scenario, command, ckpt, reference_ckpt):
    """``ELASTIC[scenario]``: its runs in order on ``ckpt`` and its
    uninterrupted run on ``reference_ckpt``, each ``command`` + the
    checkpoint directory + ``ELASTIC_FLAGS`` + its flags. Returns the runs'
    outputs (a list per run of each process's (stdout, stderr))."""
    spec = ELASTIC[scenario]
    ranks, flags = spec["reference"]
    run_trainer([*command, "--path-ckpt=%s" % reference_ckpt,
                 *ELASTIC_FLAGS, *flags], ranks)
    return [run_trainer([*command, "--path-ckpt=%s" % ckpt, *ELASTIC_FLAGS,
                         *flags], ranks, expect_rc=rc)
            for ranks, flags, rc in spec["runs"]]


def run_scenario(scenario, workdir, ranks=2, **kwargs):
    """``launch`` this file's ``scenario``; returns each rank's npz as a
    dict."""
    launch([sys.executable, os.path.abspath(__file__), scenario,
            str(workdir)], ranks=ranks, **kwargs)
    return [dict(np.load(os.path.join(str(workdir), "%s-rank%d.npz"
                                      % (scenario, r))))
            for r in range(ranks)]


# ---------------------------------------------------------------- ranks


def _inputs(workdir):
    data = dict(np.load(os.path.join(workdir, "inputs.npz")))
    spec = json.loads(str(data.pop("spec")))
    state = {k[3:]: torch.from_numpy(v) for k, v in data.items()
             if k.startswith("sd/")}
    arrays = {k: v for k, v in data.items() if not k.startswith("sd/")}
    return spec, state, arrays


def _no_dropout(model):
    for module in model.modules():
        if isinstance(module, torch.nn.Dropout):
            module.p = 0.0
    return model


def _flat(prefix, tensors):
    return {prefix + k: v.detach().numpy().copy() for k, v in tensors.items()}


def _srf_state(spec, state, mesh, fsdp=False, bf16=False, model_axis=False,
               with_ema=False):
    from srf_tpu_torch.models.layers import set_batch_norm_group
    from srf_tpu_torch.models.srf import SequenceRouter
    from srf_tpu_torch.parallel import sharding_rules
    from srf_tpu_torch.train import optimizer
    from srf_tpu_torch.train.state import TrainState

    model = _no_dropout(SequenceRouter(**spec["model"]))
    model.load_state_dict(state)
    set_batch_norm_group(model, mesh.group("data"))
    if fsdp:
        sharding_rules.fsdp(model, mesh, bf16=bf16)
    if model_axis:
        sharding_rules.apply_rules(model, mesh)
    config = type("Config", (), spec["optimizer"])
    opt, scheduler = optimizer.get_optimizer(config, model.parameters())
    return TrainState.create(model, opt, scheduler, device="cpu",
                             with_ema=with_ema)


def _local_batch(arrays, rank, ranks):
    rows = arrays["feats"].shape[0] // ranks
    part = slice(rank * rows, (rank + 1) * rows)
    return {k: torch.from_numpy(arrays[k][part])
            for k in ("feats", "labels", "inp_len", "tar_len")}


def dp(workdir):
    """The data-parallel SRF step of the world: two steps (accum 1), one
    step at accum 2, two FSDP steps with their checkpoint (rank 0 writes),
    one ``--tpu-bf16`` step unsharded and under FSDP, and one MWER update;
    ``spec["runs"]``, where given, keeps only those runs and no MWER update
    (the (data 1, model 2) mesh is made on 2 ranks only)."""
    from srf_tpu_torch.parallel import distributed, sharding_rules
    from srf_tpu_torch.parallel.mesh import broadcast_state, make_mesh
    from srf_tpu_torch.train import step
    from srf_tpu_torch.utils.checkpoint import CheckpointManager

    spec, state_dict, arrays = _inputs(workdir)
    rank, ranks = distributed.rank(), distributed.world_size()
    mesh = make_mesh(device="cpu")
    group = mesh.group("data")
    batch = _local_batch(arrays, rank, ranks)
    div = spec["in_len_div"]
    out = {}
    if ranks == 2:
        # the (data 1, model 2) mesh of the same two ranks
        model_mesh = make_mesh(1, num_model=2, device="cpu")
        out = {"model_mesh/shape": np.array([model_mesh.shape["data"],
                                             model_mesh.shape["model"]]),
               "model_mesh/index": np.array([model_mesh.index("data"),
                                             model_mesh.index("model")]),
               "model_mesh/sizes": np.array([
                   distributed.world_size(model_mesh.group("data")),
                   distributed.world_size(model_mesh.group("model"))])}
    runs = [run for run in (
        ("dp", 1, 2, False, False), ("accum", 2, 1, False, False),
        ("fsdp", 1, 2, True, False), ("dp_bf16", 1, 1, False, True),
        ("fsdp_bf16", 1, 1, True, True))
        if run[0] in spec.get("runs", [run[0]])]
    for label, accum, steps, fsdp, bf16 in runs:
        state = broadcast_state(_srf_state(spec, state_dict, mesh, fsdp,
                                           bf16))
        train_step = step.make_train_step(
            step.make_apply_fn(state.model, bf16=bf16), div,
            accum_steps=accum, group=group)
        for i in range(steps):
            state, metrics = train_step(state, batch, 1234)
            for key, value in metrics.items():
                out["%s/metrics/%d/%s" % (label, i, key)] = value.item()
            if i == 0:
                grads = {k: p.grad for k, p in
                         state.model.named_parameters()}
                out.update(_flat(label + "/grad/",
                                 sharding_rules.full_state(grads)))
        tree = sharding_rules.full_state(state.model.state_dict())
        out.update(_flat(label + "/state/", tree))
        if label == "dp":
            valid = step.make_valid_step(step.make_apply_fn(state.model),
                                         div, group)(state, batch)
            out["valid/loss_sum"] = valid["loss_sum"].item()
            out["valid/samples"] = valid["samples"].item()
        if label == "fsdp":
            from srf_tpu_torch.trainer_sr import state_to_tree

            saved = state_to_tree(state)
            if rank == 0:
                CheckpointManager(os.path.join(workdir, "fsdp_ckpt")).save(
                    state.step, saved)
            distributed.barrier()
    if "runs" in spec:
        np.savez(os.path.join(workdir, "dp-rank%d.npz" % rank), **out)
        return
    # one MWER update: each rank decodes its own rows' n-best
    from srf_tpu_torch.train.mwer import make_mwer_train_step

    state = broadcast_state(_srf_state(spec, state_dict, mesh))
    apply_fn = step.make_apply_fn(state.model)
    mwer_step = make_mwer_train_step(
        apply_fn, step.make_logits_fn(apply_fn), div, beam_width=8,
        n_best=3, blank_id=spec["model"]["class_n"] - 1, group=group)
    state, metrics = mwer_step(state, batch, 3)
    for key, value in metrics.items():
        out["mwer/metrics/0/%s" % key] = value.item()
    out.update(_flat("mwer/grad/", {k: p.grad for k, p in
                                    state.model.named_parameters()}))
    np.savez(os.path.join(workdir, "dp-rank%d.npz" % rank), **out)


def loader(workdir):
    """Both multi-process loader modes for 2 epochs: each step's utt ids
    and padded shapes."""
    from srf_tpu_torch.data.loader import BucketedLoader, SpeechDataset
    from srf_tpu_torch.parallel import distributed

    spec, _, _ = _inputs(workdir)
    rank, ranks = distributed.rank(), distributed.world_size()
    pattern = os.path.join(workdir, spec["pattern"])
    out = {}
    for mode in ("global_sync", "shard_batches"):
        sharded = mode == "global_sync"
        ds = SpeechDataset(pattern, spec["feat_dim"], with_utt_id=True,
                           process_index=rank if sharded else 0,
                           process_count=ranks if sharded else 1)
        sizes = [bs // ranks for bs in spec["batch_sizes"]] if sharded \
            else spec["batch_sizes"]
        loader_ = BucketedLoader(ds, spec["boundaries"], sizes, shuffle=True,
                                 seed=7, prefetch=0, process_index=rank,
                                 process_count=ranks, **{mode: True})
        for epoch in range(2):
            loader_.set_epoch(epoch)
            steps = list(loader_)
            out["%s/%d/ids" % (mode, epoch)] = np.array(
                ["|".join(b["utt_ids"]) for b in steps])
            out["%s/%d/shapes" % (mode, epoch)] = np.array(
                [b["feats"].shape for b in steps])
        out["%s/batch_shapes" % mode] = np.array(loader_.batch_shapes())
    np.savez(os.path.join(workdir, "loader-rank%d.npz" % rank), **out)


def ring(workdir):
    """ring_attention over the world: output and the gradients of q, k, v
    for a fixed cotangent."""
    from srf_tpu_torch.ops.blockwise_attention import PenaltyParams
    from srf_tpu_torch.ops.ring_attention import ring_attention
    from srf_tpu_torch.parallel import distributed

    spec, _, arrays = _inputs(workdir)
    q, k, v = (torch.from_numpy(arrays[n]).requires_grad_()
               for n in ("q", "k", "v"))
    penalty = PenaltyParams(*spec["penalty"]) if spec["penalty"] else None
    out = ring_attention(q, k, v, torch.distributed.group.WORLD,
                         torch.from_numpy(arrays["mask"]), penalty)
    (out * torch.from_numpy(arrays["cot"])).sum().backward()
    np.savez(os.path.join(workdir, "ring-rank%d.npz" % distributed.rank()),
             out=out.detach().numpy(), dq=q.grad.numpy(), dk=k.grad.numpy(),
             dv=v.grad.numpy())


def pipeline(workdir):
    """The STF pipelined over a (data, pipe) mesh of the world in eval
    mode: logits and the gradients of mean(logits^2) (summed over the
    mesh) for each (microbatches, remat) of the spec."""
    from srf_tpu_torch.models.stf import ConvEncoder
    from srf_tpu_torch.parallel import distributed
    from srf_tpu_torch.parallel.mesh import make_pipeline_mesh
    from srf_tpu_torch.parallel.pipeline import make_pipeline_apply_fn
    from srf_tpu_torch.train.step import all_reduce_gradients

    spec, state_dict, arrays = _inputs(workdir)
    mesh = make_pipeline_mesh(spec["stages"], device="cpu")
    data_rank = mesh.index("data")
    rows = arrays["feats"].shape[0] // mesh.shape["data"]
    part = slice(data_rank * rows, (data_rank + 1) * rows)
    batch = {"feats": torch.from_numpy(arrays["feats"][part]),
             "inp_len": torch.from_numpy(arrays["inp_len"][part])}
    out = {}
    for micro, remat in spec["runs"]:
        model = ConvEncoder(**spec["model"])
        model.load_state_dict(state_dict)
        apply_fn = make_pipeline_apply_fn(model, mesh, micro, in_len_div=4,
                                          remat=remat)
        logits = apply_fn(batch, False)
        (logits * logits).mean().backward()
        all_reduce_gradients(model, torch.distributed.group.WORLD)
        key = "%d-%d" % (micro, remat)
        out[key + "/logits"] = logits.detach().numpy()
        out.update(_flat(key + "/grad/", {
            k: p.grad for k, p in model.named_parameters()}))
    np.savez(os.path.join(workdir, "pipeline-rank%d.npz"
                          % distributed.rank()), **out)


def _routing_cases(spec, arrays, mesh, out):
    """The split routing on this rank's shard of the whole W and b: for
    each (SDR or DR, PAD mask, iterations) case the forward and the
    gradients of <out, cotangent>."""
    from srf_tpu_torch.ops.routing import route_layer
    from srf_tpu_torch.parallel import distributed

    group = mesh.group("model")
    size, index = mesh.shape["model"], mesh.index("model")
    wgt, bias = (torch.from_numpy(arrays["route/" + n]) for n in ("W", "b"))
    length = wgt.shape[1] // size
    part = slice(index * length, (index + 1) * length)
    for is_context, is_last, num_iter in spec["routing"]:
        key = "route/%d%d%d/" % (is_context, is_last, num_iter)
        u = torch.from_numpy(arrays["route/u"]).requires_grad_()
        w = wgt[:, part].contiguous().requires_grad_()
        b = bias[:, part].contiguous().requires_grad_()
        got = route_layer(u, w, b, num_iter, bool(is_context), bool(is_last),
                          shard=(index * length, wgt.shape[1], group))
        cot = torch.from_numpy(arrays["route/cot"])[:, :, part]
        (got * cot).sum().backward()
        out.update(_flat(key, {"out": got, "du": u.grad, "dW": w.grad,
                               "db": b.grad}))
    out["route/group_size"] = distributed.world_size(group)
    # K1-tp's and K2-tp's exchanges (routing_cuda), on this rank's tensors
    from srf_tpu_torch.ops import routing_cuda

    local = torch.tensor([[float(index), 1.0 + n] for n in range(3)])
    out["exchange/pairs"] = routing_cuda._gather_pairs(local, group).numpy()
    out["exchange/sum"] = routing_cuda._sum_over(local.clone(), group).numpy()


def model_axis(workdir):
    """A (data, model) mesh of the world (``spec["mesh"]``): the split
    routing cases (``spec["routing"]``), two train steps of the SRF with
    its class capsules sharded over ``model``, their gradients, state and
    seeds; the checkpoint of the sharded state (rank 0 writes) and its
    eval logits; broadcast_state over a shard; one accumulated step with
    an EMA."""
    from srf_tpu_torch.parallel import distributed, sharding_rules
    from srf_tpu_torch.parallel.mesh import broadcast_state, make_mesh
    from srf_tpu_torch.train import step
    from srf_tpu_torch.trainer_sr import state_to_tree
    from srf_tpu_torch.utils.checkpoint import CheckpointManager

    spec, state_dict, arrays = _inputs(workdir)
    num_data, num_model = spec["mesh"]
    mesh = make_mesh(num_data, num_model, device="cpu")
    data, model_group = mesh.group("data"), mesh.group("model")
    rank = distributed.rank()
    out = {"mesh/index": np.array([mesh.index("data"), mesh.index("model")]),
           "mesh/sizes": np.array([distributed.world_size(data),
                                   distributed.world_size(model_group)])}
    if spec.get("routing"):
        _routing_cases(spec, arrays, mesh, out)
    div = spec["in_len_div"]
    batch = _local_batch(arrays, mesh.index("data"), num_data)

    state = broadcast_state(_srf_state(spec, state_dict, mesh,
                                       model_axis=True))
    shard = sharding_rules.model_shard(state.model)
    out["specs"] = np.array(sorted("%s:%d:%d:%d:%d" % (k, *v)
                                   for k, v in shard.spans.items()))
    apply_fn = step.make_apply_fn(state.model)
    train_step = step.make_train_step(apply_fn, div, group=data,
                                      model_group=model_group)
    out["seed"] = step.step_seed(1234, 0, distributed.rank(data))
    for i in range(2):
        state, metrics = train_step(state, batch, 1234)
        for key, value in metrics.items():
            out["step/metrics/%d/%s" % (i, key)] = value.item()
        if i == 0:
            grads = {k: p.grad for k, p in state.model.named_parameters()}
            out.update(_flat("step/local_grad/", grads))
            out.update(_flat("step/grad/", sharding_rules.gather_named(
                grads, state.model)))
    out["step/moment_shapes"] = np.array(sorted(
        "%d:%s" % (i, "x".join(map(str, s["exp_avg"].shape)))
        for i, s in enumerate(state.optimizer.state.values())))
    tree = state_to_tree(state)
    out.update(_flat("step/state/", tree["model"]))
    if rank == 0:
        CheckpointManager(os.path.join(workdir, "ckpt")).save(state.step,
                                                             tree)
    distributed.barrier()
    valid = step.make_valid_step(apply_fn, div, data, model_group)(state,
                                                                  batch)
    out["valid/loss_sum"] = valid["loss_sum"].item()
    out["valid/samples"] = valid["samples"].item()
    with torch.no_grad():
        out["logits"] = apply_fn(batch, False).numpy()

    # broadcast_state: rank 1's own weights moved off rank 0's first
    state = _srf_state(spec, state_dict, mesh, model_axis=True)
    if rank == 1:
        with torch.no_grad():
            for p in state.model.parameters():
                p.add_(1.0)
    broadcast_state(state)
    out.update(_flat("bcast/", dict(state.model.named_parameters())))

    if spec.get("accum"):
        state = broadcast_state(_srf_state(spec, state_dict, mesh,
                                           model_axis=True, with_ema=True))
        accum_step = step.make_train_step(
            step.make_apply_fn(state.model), div, accum_steps=2,
            ema_decay=0.9, group=data, model_group=model_group)
        state, metrics = accum_step(state, batch, 1234)
        out["accum/loss_sum"] = metrics["loss_sum"].item()
        tree = state_to_tree(state)
        out.update(_flat("accum/state/", tree["model"]))
        out.update(_flat("accum/ema/", tree["ema"]))

    # what a shard reached only from ROADMAP item 7c on: bf16 routing, the
    # wavefront and the streaming route_block on the sharded model
    model = _srf_state(spec, state_dict, mesh, model_axis=True).model.eval()
    feats, lens = batch["feats"], batch["inp_len"]
    with torch.no_grad():
        out["7c/logits"] = model(feats, lens).numpy()
        model.routing_bf16 = True
        out["7c/bf16_logits"] = model(feats, lens).numpy()
        model.routing_bf16, model.routing_impl = False, "wavefront"
        out["7c/wavefront_logits"] = model(feats, lens).numpy()
        last = model.enc_num - 1
        n = spec["model"]["caps_conv_num"]
        d = spec["model"]["caps_conv_dim"]
        u_ctx = torch.ones(2, 6, n, d) * torch.linspace(-1, 1, d)
        v_init = torch.full((2, spec["model"]["class_n"],
                             spec["model"]["caps_class_dim"]), 0.1)
        block, v_last = model.route_block(u_ctx, last, v_init,
                                          torch.arange(4) >= 1)
        out["7c/route_block"] = block.numpy()
        out["7c/v_last"] = v_last.numpy()
    np.savez(os.path.join(workdir, "model_axis-rank%d.npz" % rank), **out)


def model_axis_7c(workdir):
    """The ``model`` axis beyond the layered float32 path on a (data 1,
    model ranks) mesh. ``spec["bf16"]``: bf16 routing on this rank's shard
    of route/W and route/b (``route_layer(..., bf16=True, shard=...)``),
    for each (iterations, PAD mask) case the output and the gradients of
    <out, cotangent>. ``spec["model"]``: the SRF with ``apply_rules``'s
    sharded class layer, in eval mode: its last layer's ``route_block``
    with a carry and a step mask (rb/*), one ``stream_step`` of two rows
    (ss/*), a ``StreamingTranscriber`` over the utterance ``raw``, and the
    wavefront forward of ``feats``."""
    from srf_tpu_torch.models.srf import SequenceRouter
    from srf_tpu_torch.ops.routing import route_layer
    from srf_tpu_torch.parallel import distributed, sharding_rules
    from srf_tpu_torch.parallel.mesh import make_mesh
    from srf_tpu_torch.streaming import StreamingTranscriber

    spec, state_dict, arrays = _inputs(workdir)
    mesh = make_mesh(1, spec["ranks"], device="cpu")
    group = mesh.group("model")
    size, index = mesh.shape["model"], mesh.index("model")
    out = {}
    for num_iter, is_last in spec.get("bf16", []):
        wgt, bias = (torch.from_numpy(arrays["route/" + n]) for n in ("W",
                                                                      "b"))
        length = wgt.shape[1] // size
        part = slice(index * length, (index + 1) * length)
        u = torch.from_numpy(arrays["route/u"]).requires_grad_()
        w = wgt[:, part].contiguous().requires_grad_()
        b = bias[:, part].contiguous().requires_grad_()
        got = route_layer(u, w, b, num_iter, True, bool(is_last), bf16=True,
                          shard=(index * length, wgt.shape[1], group))
        (got * torch.from_numpy(arrays["route/cot"])[:, :, part]).sum(
            ).backward()
        out.update(_flat("bf16/%d%d/" % (num_iter, is_last),
                         {"out": got, "du": u.grad, "dW": w.grad,
                          "db": b.grad}))
    if "model" in spec:
        model = SequenceRouter(**spec["model"])
        model.load_state_dict(state_dict)
        model.eval()
        sharding_rules.apply_rules(model, mesh)
        assert sharding_rules.model_shard(model).layer(model.enc_num - 1)
        t = lambda k: torch.from_numpy(arrays[k])
        with torch.no_grad():
            block, v_last = model.route_block(
                t("rb/u_ctx"), model.enc_num - 1, t("rb/v_init"),
                t("rb/valid"))
            logits, bufs, vprevs = model.stream_step(
                t("ss/window"), t("ss/length"), list(spec["lpost"]),
                [t("ss/buf%d" % i) for i in range(model.enc_num)],
                [t("ss/vprev%d" % i) for i in range(model.enc_num)],
                arrays["ss/offsets"])
        out.update(_flat("rb/", {"out": block, "v_last": v_last}))
        out.update(_flat("ss/", {"logits": logits}))
        out.update(_flat("ss/", {"buf%d" % i: x for i, x in enumerate(bufs)}))
        out.update(_flat("ss/", {"vprev%d" % i: x
                                 for i, x in enumerate(vprevs)}))
        session = StreamingTranscriber(model, blank_id=spec["blank"],
                                       chunk=spec["chunk"])
        raw = arrays["raw"]
        for start in range(0, raw.shape[0], 7):
            session.push(raw[start:start + 7])
        session.flush()
        out["stream/logits"] = np.asarray(session.logits)
        model.routing_impl = "wavefront"
        with torch.no_grad():
            out["wavefront/logits"] = model(t("feats"), t("lens")).numpy()
    out["group_size"] = np.array(distributed.world_size(group))
    np.savez(os.path.join(workdir, "model_axis_7c-rank%d.npz"
                          % distributed.rank()), **out)


SCENARIOS = {"dp": dp, "loader": loader, "ring": ring, "pipeline": pipeline,
             "model_axis": model_axis, "model_axis_7c": model_axis_7c}


def main(scenario, workdir):
    from srf_tpu_torch.parallel import distributed

    torch.set_num_threads(1)
    distributed.maybe_initialize(device="cpu")
    try:
        SCENARIOS[scenario](workdir)
        distributed.barrier()
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:3])
