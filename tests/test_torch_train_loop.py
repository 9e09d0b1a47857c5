"""The port's training loop (``train/loop.run_training``) and resume
against ``srf_tpu``'s, on the CPU at a small SRF (L=2, narrow, one batch
shape, dropout off on both sides: flax's ``Dropout`` patched to the
identity, the port's rates 0).

- **Parity.** Both ``run_training`` loops (JAX's with no mesh) from the same
  numpy weights over the same batches (each package's ``BucketedLoader``
  over one dataset, shuffled by epoch; a valid loader whose labels get
  longer each pass, so the valid loss worsens and early stopping triggers)
  for up to 4 epochs of 52 steps: per-epoch train and valid losses within
  rtol 1e-4 (float32 sums in other orders through 156 Adam updates), the
  same early-stop epoch, the same saved steps, the same ``STEP`` and
  ``Epoch`` lines apart from their numbers (which agree to 1e-4, the
  seconds aside) and the same ``metrics.jsonl`` kinds.
- **Resume is exact on the CPU.** A run stopped after a mid-epoch
  checkpoint (the test's train step raises) and resumed ends with a
  ``state_dict`` (model, optimizer, scheduler) equal bit for bit to the
  uninterrupted run's.
- **Refused mid checkpoints** (another batch geometry, unreadable, stale)
  are purged and the run starts from its epoch offset; an epoch or a
  validation pass with no batches is logged loudly.
- **The resumed rate** (``utils/checkpoint.restore_into``): a stage resumed
  with another ``--train-lr-param-k`` runs its first update at the new
  flags' rate at the restored count, as optax does, for the default Noam
  and for ``--train-opti-type=adam``/``sgd``: the rate (within optax's
  float32), the parameters after that update within 1e-5.
- **Spans** (``utils/profiler.py``): ``device_prefetch`` yields each
  batch's step keys as tensors from one loop, each batch in a ``srf.feed``
  span around ``srf.feed.load`` and ``srf.feed.put``; a train step is a
  ``srf.step`` span around its forward, loss and backward a microbatch and
  one optimizer span.
"""

import io
import json
import logging
import os
import re
import time

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import torch

from srf_tpu import trainer_sr as jax_trainer
from srf_tpu.config import ParseOption as JaxParseOption
from srf_tpu.data.loader import BucketedLoader as JaxBucketedLoader
from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.train import loop as jax_loop
from srf_tpu.train import optimizer as jax_optimizer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu.utils import checkpoint as jax_checkpoint
from srf_tpu_torch import convert, trainer_sr
from srf_tpu_torch.config import ParseOption
from srf_tpu_torch.data.loader import BucketedLoader
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.train import loop, optimizer, step
from srf_tpu_torch.train.state import TrainState
from srf_tpu_torch.utils import checkpoint, profiler

from _torch_parity import no_dropout, random_flax_variables

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEAT_DIM, CLASS_N, IN_LEN_DIV = 8, 7, 4
MODEL = dict(
    feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=2, caps_primary_num=4,
    caps_primary_dim=2, caps_conv_num=3, caps_conv_dim=2, caps_class_dim=2,
    caps_iter=1, lpad=1, rpad=1, is_context=True, conv_layer_num=2,
    conv_filter_num=4, caps_type="naive", inp_dropout=0.0, inn_dropout=0.0,
)
QUIET = logging.getLogger("test_torch_train_loop.quiet")
QUIET.setLevel(logging.ERROR)
LOSS_RTOL = 1e-4


class Dataset:
    """The in-memory dataset both packages' loaders read."""

    def __init__(self, n, seed):
        rng = np.random.RandomState(seed)
        self.feat_dim = FEAT_DIM
        self.feats, self.labels = [], []
        for _ in range(n):
            # 7-8 frames after the front end: room for every label
            # sequence, the valid loader's longer ones too (no infeasible
            # alignment, where the two CTC losses differ by design, F4)
            frames = int(rng.randint(28, 33))
            self.feats.append(rng.randn(frames, FEAT_DIM).astype(np.float32))
            self.labels.append(rng.randint(1, CLASS_N - 1, size=int(
                rng.randint(2, 4))).astype(np.int32))
        self.utt_ids = None
        self.inp_lens = np.asarray([f.shape[0] for f in self.feats])
        self.lab_lens = np.asarray([l.shape[0] for l in self.labels])

    def __len__(self):
        return len(self.feats)


class WorseningValid:
    """Valid batches of 2 whose labels grow by one id each pass, so the
    loss worsens from the second pass on."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.passes = 0

    def __iter__(self):
        ds, extra = self.dataset, self.passes
        self.passes += 1
        for start in range(0, len(ds), 2):
            labels = [np.concatenate([l, np.full(extra, 1, np.int32)])
                      for l in ds.labels[start:start + 2]]
            width = max(l.size for l in labels)
            yield {
                "feats": np.stack([np.pad(f, ((0, 32 - f.shape[0]), (0, 0)))
                                   for f in ds.feats[start:start + 2]]),
                "labels": np.stack([np.pad(l, (0, width - l.size))
                                    for l in labels]),
                "inp_len": np.asarray([f.shape[0] for f in
                                       ds.feats[start:start + 2]], np.int32),
                "tar_len": np.asarray([l.size for l in labels], np.int32),
            }


def _argv(ckpt, *extra):
    return ["loop", "--path-base=%s" % REPO, "--path-ckpt=%s" % ckpt,
            "--train-max-epoch=4",
            "--train-es-tolerance=2", "--train-lr-param-k=0.5",
            "--train-warmup-n=40", "--model-ckpt-max-to-keep=-1", *extra]


def _capture(name):
    stream = io.StringIO()
    logger = logging.getLogger("test_torch_train_loop." + name)
    logger.setLevel(logging.INFO)
    logger.handlers = [logging.StreamHandler(stream)]
    logger.propagate = False
    return logger, stream


def _port_state(variables, config):
    model = no_dropout(SequenceRouter(**MODEL))
    model.load_state_dict(convert.flax_to_state_dict(variables))
    opt, scheduler = optimizer.get_optimizer(config, model.parameters())
    return TrainState.create(model, opt, scheduler, device="cpu")


def _run_port(tmp, variables, train_ds, valid, *extra):
    config = ParseOption(_argv(tmp, *extra), QUIET,
                         is_print_opts=False).args
    state = _port_state(variables, config)
    manager, _, offset = checkpoint.load_checkpoint(config, QUIET, state)
    apply_fn = step.make_apply_fn(state.model)
    logger, log = _capture("torch")
    loop.run_training(
        config, logger, state,
        step.make_train_step(apply_fn, IN_LEN_DIV),
        step.make_valid_step(apply_fn, IN_LEN_DIV),
        BucketedLoader(train_ds, [], [2], shuffle=True, seed=7), valid,
        manager, offset, 1234, len(train_ds),
        schedule_fn=state.scheduler.lr_lambdas[0],
        metrics_path=os.path.join(tmp, "metrics.jsonl"),
        state_to_save=trainer_sr.state_to_tree,
        state_from_tree=lambda tree: checkpoint.restore_into(state, tree))
    return state, log.getvalue()


def _records(path):
    with open(path) as lines:
        return [json.loads(line) for line in lines]


def _numbers(text):
    """The numbers of a printed line but its seconds."""
    text = re.sub(r"[\d.]+ secs", "secs", text)
    return [float(x) for x in re.findall(r"-?\d+\.\d+|-?\d+", text)]


@pytest.fixture(scope="module")
def variables():
    return random_flax_variables(FlaxSequenceRouter(**MODEL), FEAT_DIM,
                                 seed=3)


def test_run_training_matches_jax(tmp_path, variables, monkeypatch, capsys):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    train_ds, valid_ds = Dataset(104, seed=1), Dataset(6, seed=2)

    config = JaxParseOption(_argv(tmp_path / "jax"), QUIET,
                            is_print_opts=False).args
    flax_model = FlaxSequenceRouter(**MODEL)
    tx, schedule = jax_optimizer.get_optimizer(config)
    jax_state = JaxTrainState.create(
        jax.tree.map(jnp.asarray, variables["params"]), tx,
        jax.tree.map(jnp.asarray, variables["batch_stats"]))
    apply_fn = jax_step.make_apply_fn(flax_model)
    manager = jax_checkpoint.CheckpointManager(str(tmp_path / "jax"))
    logger, jax_log = _capture("jax")
    capsys.readouterr()
    jax_loop.run_training(
        config, logger, jax_state,
        jax_step.make_train_step(apply_fn, tx, IN_LEN_DIV, mesh=None,
                                 donate=False),
        jax_step.make_valid_step(apply_fn, IN_LEN_DIV),
        JaxBucketedLoader(train_ds, [], [2], shuffle=True, seed=7),
        WorseningValid(valid_ds), manager, 0, jax.random.PRNGKey(0),
        len(train_ds), schedule_fn=schedule,
        metrics_path=str(tmp_path / "jax" / "metrics.jsonl"),
        state_to_save=jax_trainer.state_to_tree,
        state_from_tree=jax_trainer.tree_to_state)
    jax_steps = manager.all_steps()
    manager.close()
    jax_out = capsys.readouterr().out

    _, log = _run_port(tmp_path / "torch", variables, train_ds,
                       WorseningValid(valid_ds))
    out = capsys.readouterr().out

    # epoch 3 worsens a second time: early stop before its checkpoint
    assert jax_steps == [1, 2]
    assert checkpoint.CheckpointManager(str(tmp_path / "torch")
                                        ).all_steps() == [1, 2]
    want = _records(tmp_path / "jax" / "metrics.jsonl")
    got = _records(tmp_path / "torch" / "metrics.jsonl")
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "train_epoch", "valid_epoch"] * 3
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        for key in ("epoch", "step", "samples", "better", "tolerance"):
            assert g.get(key) == w.get(key), key
    # the printed lines: same words, same numbers but the last digits
    # (and the seconds)
    for got_text, want_text, prefix in ((out, jax_out, "STEP"),
                                        (log, jax_log.getvalue(), "Epoch")):
        got_lines = [l for l in got_text.splitlines() if l.startswith(prefix)]
        want_lines = [l for l in want_text.splitlines()
                      if l.startswith(prefix)]
        assert len(got_lines) == len(want_lines) > 0
        for g, w in zip(got_lines, want_lines):
            assert re.sub(r"[\d.]+", "#", g) == re.sub(r"[\d.]+", "#", w)
            for a, b in zip(_numbers(g), _numbers(w)):
                assert a == pytest.approx(b, rel=LOSS_RTOL, abs=1e-7), (g, w)
    assert len([l for l in out.splitlines() if l.startswith("STEP")]) == 3
    assert "early stopped!" in log


class Interrupt(Exception):
    pass


def test_mid_epoch_resume_is_bit_exact(tmp_path, variables):
    train_ds, valid_ds = Dataset(20, seed=4), Dataset(4, seed=5)
    flags = ("--train-max-epoch=2", "--tpu-ckpt-every-steps=3",
             "--train-es-tolerance=100")
    want, _ = _run_port(tmp_path / "whole", variables, train_ds,
                        WorseningValid(valid_ds), *flags)

    config = ParseOption(_argv(tmp_path / "cut", *flags), QUIET,
                         is_print_opts=False).args
    state = _port_state(variables, config)
    real = step.make_train_step(step.make_apply_fn(state.model), IN_LEN_DIV)

    def stopping_step(state, batch, seed):
        if state.step == 15:  # epoch 2's 6th batch; mid saved after its 3rd
            raise Interrupt
        return real(state, batch, seed)

    with pytest.raises(Interrupt):
        loop.run_training(
            config, QUIET, state, stopping_step,
            step.make_valid_step(step.make_apply_fn(state.model), IN_LEN_DIV),
            BucketedLoader(train_ds, [], [2], shuffle=True, seed=7),
            WorseningValid(valid_ds),
            checkpoint.CheckpointManager(str(tmp_path / "cut")), 0, 1234,
            len(train_ds), state_to_save=trainer_sr.state_to_tree,
            state_from_tree=lambda tree: checkpoint.restore_into(state, tree))
    assert checkpoint.CheckpointManager(str(tmp_path / "cut" / "mid")
                                        ).all_steps() == [9, 13]
    # the valid loader's pass count is part of what it yields: the resumed
    # run gets a loader one pass on, as the restarted process's would be
    valid = WorseningValid(valid_ds)
    valid.passes = 1
    got, log = _run_port(tmp_path / "cut", variables, train_ds, valid, *flags)
    assert "Resuming mid-epoch" in log and "epoch 1, batch 3" in log
    assert got.step == want.step == 20
    for name, tree in (("model", lambda s: s.model.state_dict()),
                       ("optimizer", lambda s: s.optimizer.state_dict()),
                       ("scheduler", lambda s: s.scheduler.state_dict())):
        a, b = tree(got), tree(want)
        flat_a = convert_flat(a)
        flat_b = convert_flat(b)
        assert flat_a.keys() == flat_b.keys(), name
        for key in flat_b:
            va, vb = flat_a[key], flat_b[key]
            if torch.is_tensor(vb):
                assert torch.equal(va, vb), (name, key)
            else:
                assert va == vb, (name, key)


def convert_flat(tree, prefix=""):
    flat = {}
    if isinstance(tree, dict):
        for key, value in tree.items():
            flat.update(convert_flat(value, "%s/%s" % (prefix, key)))
    elif isinstance(tree, (list, tuple)):
        for i, value in enumerate(tree):
            flat.update(convert_flat(value, "%s/%d" % (prefix, i)))
    else:
        flat[prefix] = tree
    return flat


@pytest.mark.parametrize("case", ["geometry", "unreadable", "stale"])
def test_refused_mid_checkpoints_are_purged(tmp_path, variables, case):
    train_ds, valid_ds = Dataset(12, seed=6), Dataset(4, seed=5)
    flags = ("--train-max-epoch=2", "--tpu-ckpt-every-steps=2",
             "--train-es-tolerance=100")
    mid = checkpoint.CheckpointManager(str(tmp_path / "mid"))
    resume = dict.fromkeys(loop.RESUME_KEYS, 0.0)
    resume.update(epoch=0, batch_index=2, batch_sig=2.0)  # batch sizes [2]
    config = ParseOption(_argv(tmp_path, *flags), QUIET,
                         is_print_opts=False).args
    tree = trainer_sr.state_to_tree(_port_state(variables, config))
    tree["step"] = 2
    if case == "geometry":
        resume["batch_sig"] = 3.0  # written under batch size 3
    elif case == "stale":
        checkpoint.CheckpointManager(str(tmp_path)).save(1, tree | {"step": 6})
    mid.save(2, {"state": tree, "resume": resume})
    if case == "unreadable":
        with open(os.path.join(mid.path, "2", checkpoint.STATE_FILE),
                  "wb") as broken:
            broken.write(b"not a checkpoint")
    state, log = _run_port(tmp_path, variables, train_ds,
                           WorseningValid(valid_ds), *flags)
    assert "Resuming mid-epoch" not in log
    assert {"geometry": "different batch geometry",
            "unreadable": "unreadable", "stale": "stale"}[case] in log
    records = _records(tmp_path / "metrics.jsonl")
    first = 2 if case == "stale" else 1
    assert [r["epoch"] for r in records if r["kind"] == "train_epoch"] == \
        list(range(first, 3))
    assert state.step == 12  # 6 steps an epoch, from the epoch offset
    assert mid.all_steps() == [s for s in range(2 if first == 1 else 8, 13, 2)
                               ][-2:]


def _quadratic(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(4, 3).astype(np.float32),
            rng.randn(8, 4).astype(np.float32),
            rng.randn(8, 3).astype(np.float32))


@pytest.mark.parametrize("opti_type", [None, "adam", "sgd"])
def test_resumed_stage_runs_at_the_new_rate_as_optax(tmp_path, opti_type):
    """Stage 1: 6 updates at k1; stage 2 resumes its checkpoint at k2 = k1
    / 5 (train_srf_timit.sh:65-66: 0.5, then 0.1, under Noam; a tenth of
    that for the plain rates, whose stage 1 would otherwise move the
    weights by ~3) and takes one update. The parameters after it agree
    within 1e-5: float32 rounding over 7 updates of weights of magnitude
    ~1 (measured 2.3e-6 for adam); an update at the stale rate is off by
    more than 1e-3."""
    k1, k2 = (0.5, 0.1) if opti_type is None else (0.05, 0.01)
    w0, x, y = _quadratic()
    extra = () if opti_type is None else ("--train-opti-type=%s" % opti_type,)

    def configs(parse, k):
        return parse(["opt", "--path-base=%s" % REPO,
                      "--train-lr-param-k=%s" % k,
                      "--train-warmup-n=4", "--model-dimension=1", *extra],
                     QUIET, is_print_opts=False).args

    # optax: stage 2's optimizer reads the schedule at the restored count
    def loss(w):
        return jnp.sum((x @ w - y) ** 2)

    tx1, _ = jax_optimizer.get_optimizer(configs(JaxParseOption, k1))
    w, opt_state = jnp.asarray(w0), tx1.init(jnp.asarray(w0))
    for _ in range(6):
        updates, opt_state = tx1.update(jax.grad(loss)(w), opt_state, w)
        w = w + updates
    tx2, schedule2 = jax_optimizer.get_optimizer(configs(JaxParseOption, k2))
    updates, _ = tx2.update(jax.grad(loss)(w), opt_state, w)
    want_w = np.asarray(w + updates)
    want_rate = float(schedule2(6)) if schedule2 is not None else k2

    def torch_state(k):
        param = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        model = torch.nn.ParameterDict({"w": param})
        opt, scheduler = optimizer.get_optimizer(
            configs(ParseOption, k), model.parameters())
        return TrainState(model=model, optimizer=opt, scheduler=scheduler,
                          device=torch.device("cpu"))

    def update(state):
        state.optimizer.zero_grad()
        torch.sum((torch.from_numpy(x) @ state.model["w"]
                   - torch.from_numpy(y)) ** 2).backward()
        state.optimizer.step()
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1

    stage1 = torch_state(k1)
    for _ in range(6):
        update(stage1)
    stale_rate = stage1.optimizer.param_groups[0]["lr"]
    manager = checkpoint.CheckpointManager(str(tmp_path))
    manager.save(1, trainer_sr.state_to_tree(stage1))
    stage2 = torch_state(k2)
    checkpoint.restore_into(stage2, manager.restore(1))
    rate = stage2.optimizer.param_groups[0]["lr"]
    assert rate == pytest.approx(want_rate, rel=1e-6)
    assert abs(stale_rate - rate) > 0.5 * rate  # what the resume repairs
    if stage2.scheduler is not None:
        assert stage2.scheduler.get_last_lr() == [rate]
        assert stage2.scheduler.last_epoch == 6
    for group in stage2.optimizer.param_groups:
        assert group["initial_lr" if opti_type is None else "lr"] == (
            1.0 if opti_type is None else k2)
    update(stage2)
    np.testing.assert_allclose(stage2.model["w"].detach().numpy(), want_w,
                               rtol=0, atol=1e-5)


def test_an_epoch_without_batches_is_loud(tmp_path, variables):
    """Corpora smaller than a bucket batch: the epoch and the validation
    pass say so rather than print a 0.0000 loss silently."""
    one = Dataset(1, seed=8)
    state, log = _run_port(tmp_path, variables, one,
                           BucketedLoader(one, [], [2]),
                           "--train-max-epoch=1")
    assert state.step == 0
    assert "Train epoch 001 yielded NO batches" in log
    assert "Validation yielded NO batches" in log


def _spans_since(start, *names):
    """The ring's entries named in ``names`` that began at ``start`` (ns)
    or later."""
    return [s for s in profiler.spans()
            if s.start_ns >= start and s.name in names]


@pytest.mark.parametrize("count", [0, 3])
def test_device_prefetch_yields_the_staged_batches_in_feed_spans(count):
    rng = np.random.RandomState(count)
    batches = [{"feats": rng.randn(2, 5, 3).astype(np.float32),
                "labels": rng.randint(1, 4, (2, 2)).astype(np.int32),
                "inp_len": np.array([5, 4], np.int32),
                "tar_len": np.array([2, 1], np.int32), "extra": "unused"}
               for _ in range(count)]
    start = time.perf_counter_ns()
    got = list(loop.device_prefetch(iter(batches), torch.device("cpu")))
    # what the loop yielded before it was spanned: each batch's step keys
    # as CPU tensors, in order
    assert len(got) == count
    for staged, batch in zip(got, batches):
        assert sorted(staged) == sorted(loop.STEP_KEYS)
        for key in loop.STEP_KEYS:
            assert torch.equal(staged[key], torch.from_numpy(batch[key]))
    feeds = _spans_since(start, "srf.feed")
    loads = _spans_since(start, "srf.feed.load")
    puts = _spans_since(start, "srf.feed.put")
    # a feed span a batch, and one more for the loader's end
    assert (len(feeds), len(loads), len(puts)) == (count + 1, count + 1,
                                                   count)
    assert {s.parent for s in loads + puts} <= {"srf.feed"}
    assert {s.parent for s in feeds} == {None}


def test_the_train_step_spans_its_parts_a_microbatch():
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 4)
    opt = torch.optim.SGD(model.parameters(), lr=0.1)
    state = TrainState.create(model, opt, device="cpu")
    train_step = step.make_train_step(
        lambda batch, training, generator: model(batch["feats"]), 1,
        accum_steps=2)
    batch = {"feats": torch.randn(4, 6, 3),
             "labels": torch.tensor([[1, 2]] * 4, dtype=torch.int32),
             "inp_len": torch.tensor([6, 5, 6, 4], dtype=torch.int32),
             "tar_len": torch.tensor([2, 1, 2, 2], dtype=torch.int32)}
    start = time.perf_counter_ns()
    train_step(state, batch, 1)
    names = ("srf.step", "srf.step.forward", "srf.step.loss",
             "srf.step.backward", "srf.step.optimizer")
    got = sorted(_spans_since(start, *names), key=lambda s: s.start_ns)
    assert [s.name for s in got] == ["srf.step"] + list(names[1:4]) * 2 + [
        "srf.step.optimizer"]
    assert {s.parent for s in got[1:]} == {"srf.step"}
    assert got[0].parent is None and state.step == 1
