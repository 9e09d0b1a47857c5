"""Checkpoint save/restore/resume + checkpoint averaging (port of
``srf_tpu/utils/checkpoint.py``; orbax becomes ``torch.save``).

Reference parity (tfsr/helper/misc_helper.py:139-163,
tfsr/utils/average_ckpt_sr.py:92-180):

- per-epoch checkpoints managed with ``max_to_keep``
  (``--model-ckpt-max-to-keep``, -1 = keep all),
- resume from ``--path-ckpt-epoch`` N or the latest checkpoint; the epoch
  offset is the checkpoint step; the resumed optimizer runs at the current
  flags' rate (``restore_into``), as optax reads its schedule through the
  new run's optimizer,
- checkpoint averaging: element-wise mean of the last ``model_average_num``
  checkpoints' weights saved under ``$ckpt/avg``,
- the training loop's mid-epoch checkpoints are a second manager under
  ``$ckpt/mid``; its name is not a step, so the managers and averaging of
  ``$ckpt`` never see it.

Layout: one directory per step under the manager's path, as orbax lays
them out (``<path>/<step>/state.pt``), so ``$ckpt/avg/1`` is what
``--path-ckpt=$ckpt/avg`` reads. The state is ``{"step", "model" (the
model's state_dict, BatchNorm buffers included), "optimizer",
"scheduler"}`` and, for a run with an EMA of the parameters
(``--tpu-ema-decay``), ``"ema"`` (the trained parameters' averages, keyed
as ``named_parameters``); a save writes a temporary directory and renames
it, so a step directory is either whole or absent. The file is the
one-process format whatever the world size or layout (a data-parallel or
FSDP run saves whole tensors from rank 0: ``train/loop.py``,
``parallel/sharding_rules.py``), so averaging, decoding and a resume on
another world size read it unchanged; orbax's checkpoints do not depend
on the layout either.

``--tpu-async-ckpt`` (``use_async=True``): ``save`` copies the state to
host memory before it returns (the next step may change the tensors in
place) and writes the file on a background thread; ``wait()`` joins it,
and every read waits first, as JAX's orbax manager does.
"""

import os
import shutil
import threading

import torch

STATE_FILE = "state.pt"


def _to_cpu(value, copy=False):
    """``value`` with its tensors detached on the CPU (copies of CPU
    tensors too where ``copy``)."""
    if torch.is_tensor(value):
        return value.detach().to("cpu", copy=copy)
    if isinstance(value, dict):
        return {k: _to_cpu(v, copy) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_cpu(v, copy) for v in value)
    return value


class CheckpointManager:
    """Numbered checkpoints under one directory; saves are synchronous
    unless ``use_async`` (the module docstring)."""

    def __init__(self, path, max_to_keep=None, use_async=False):
        if max_to_keep is not None and max_to_keep < 0:
            max_to_keep = None
        self.path = os.path.abspath(path)
        self.max_to_keep = max_to_keep
        self.use_async = use_async
        self._writer = None  # the background save's thread
        self._failure = []  # its exception, raised by wait()
        os.makedirs(self.path, exist_ok=True)

    def _dir(self, step):
        return os.path.join(self.path, str(int(step)))

    def save(self, step, state_dict):
        """Write ``state_dict`` (``{"step", "model", "optimizer",
        "scheduler"}``, tensors moved to the CPU) as ``step``; then drop the
        oldest steps beyond ``max_to_keep``. Asynchronous saves return
        once the host copy is made (one save is in flight at a time)."""
        self.wait()
        host = _to_cpu(state_dict, copy=self.use_async)
        if not self.use_async:
            return self._write(step, host)

        def write():
            try:
                self._write(step, host)
            except BaseException as exc:  # noqa: BLE001 - raised by wait()
                self._failure.append(exc)

        self._writer = threading.Thread(target=write, daemon=True,
                                        name="ckpt-write-%d" % step)
        self._writer.start()
        return self._dir(step)

    def _write(self, step, host):
        final = self._dir(step)
        tmp = "%s.tmp-%d" % (final, os.getpid())
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(host, os.path.join(tmp, STATE_FILE))
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        if self.max_to_keep is not None:
            for old in self._steps()[:-self.max_to_keep]:
                shutil.rmtree(self._dir(old))
        return final

    def wait(self):
        """Block until the pending asynchronous save is on disk; raise its
        error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._failure:
            raise self._failure.pop()

    def restore(self, step):
        """The checkpoint dict saved as ``step`` (tensors on the CPU)."""
        self.wait()
        path = os.path.join(self._dir(step), STATE_FILE)
        if not os.path.isfile(path):
            raise FileNotFoundError("no checkpoint %s" % path)
        return torch.load(path, map_location="cpu", weights_only=True)

    def all_steps(self):
        self.wait()
        return self._steps()

    def _steps(self):
        steps = []
        for name in os.listdir(self.path):
            if name.isdigit() and os.path.isfile(
                    os.path.join(self.path, name, STATE_FILE)):
                steps.append(int(name))
        return sorted(steps)

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def purge(self):
        """Delete every checkpoint under this manager."""
        for step in self.all_steps():
            shutil.rmtree(self._dir(step))

    def close(self):
        """Wait for the pending save."""
        self.wait()


def restore_into(state, tree, params_only=False):
    """Load a checkpoint dict into a TrainState in place. The model's
    ``load_state_dict`` is strict: a missing, extra or misshapen entry
    (model flags that do not describe the trained architecture) raises.
    ``params_only`` leaves the optimizer and scheduler as they are.

    Otherwise the optimizer's moments and counts and the scheduler's count
    come from the checkpoint, but the rate stays the current run's:
    ``Optimizer.load_state_dict`` would bring back each group's ``lr`` (and
    ``initial_lr``) as the saved run set them, and a ``LambdaLR`` only
    rewrites it at its next ``step()``, so the first update after a resume
    would run at the previous run's rate (the recipe's stage 2 resumes
    stage 1 with another ``--train-lr-param-k``). optax reads the schedule
    through the new run's optimizer at the restored count, so each group's
    rate is set to ``base_lr * lr_lambda(count)`` under a scheduler, or to
    the group's current rate (``--train-lr-param-k`` for adam and sgd)."""
    from srf_tpu_torch.parallel.sharding_rules import (
        model_shard, shard_like, shard_optimizer_state,
    )

    # an FSDP model takes each whole tensor as its shard, a model sharded
    # on the 'model' axis its slice
    live = state.model.state_dict()
    shard = model_shard(state.model)
    spans = shard.spans if shard is not None else {}
    state.model.load_state_dict({k: shard_like(v, live.get(k), spans.get(k))
                                 for k, v in tree["model"].items()})
    state.step = int(tree["step"])
    if tree.get("ema") is not None:
        device = next(state.model.parameters()).device
        params = dict(state.model.named_parameters())
        state.ema = {k: shard_like(v.to(device), params[k], spans.get(k))
                     for k, v in tree["ema"].items()}
    elif state.ema is not None:
        # an EMA asked of a checkpoint without one: for decoding there is
        # none (--tpu-decode-ema raises); training starts it afresh at the
        # restored weights
        state.ema = None
        if not params_only:
            state.reset_ema()
    if params_only:
        return state
    optimizer, scheduler = state.optimizer, state.scheduler
    if optimizer is not None and tree.get("optimizer") is not None:
        current = [{k: group[k] for k in ("lr", "initial_lr") if k in group}
                   for group in optimizer.param_groups]
        optimizer.load_state_dict(
            shard_optimizer_state(tree["optimizer"], optimizer,
                                  state.model))
        for group, rates in zip(optimizer.param_groups, current):
            group.update(rates)
    if scheduler is not None and tree.get("scheduler") is not None:
        base_lrs = list(scheduler.base_lrs)
        scheduler.load_state_dict(tree["scheduler"])
        scheduler.base_lrs = base_lrs
        rates = [base * fn(scheduler.last_epoch)
                 for base, fn in zip(base_lrs, scheduler.lr_lambdas)]
        for group, rate in zip(scheduler.optimizer.param_groups, rates):
            group["lr"] = rate
        scheduler._last_lr = rates
    return state


def load_checkpoint(config, logger, template_state, params_only=False):
    """Returns (manager, restored_state_or_None, epoch_offset).

    ``template_state`` (a TrainState; its optimizer may be None when
    ``params_only``) is restored in place from ``--path-ckpt-epoch`` when it
    is positive, else from the latest step. ``params_only=True``
    (decode/inference) loads the step and the model only, so decoding never
    depends on the training-time optimizer flags."""
    manager = CheckpointManager(
        config.path_ckpt, max_to_keep=config.model_ckpt_max_to_keep,
        use_async=bool(getattr(config, "tpu_async_ckpt", False)),
    )
    step = None
    if config.path_ckpt_epoch is not None and config.path_ckpt_epoch > 0:
        step = config.path_ckpt_epoch
    elif manager.latest_step() is not None:
        step = manager.latest_step()

    if step is None:
        logger.info("Loaded ckpt: None")
        return manager, None, 0
    restored = restore_into(template_state, manager.restore(step),
                            params_only=params_only)
    logger.info("Loaded ckpt: %s/%d%s", manager.path, step,
                " (params only)" if params_only else "")
    return manager, restored, int(step)


def _flat_floats(tree):
    """{(part, name): tensor} of the floating tensors of a checkpoint's
    "model" and, if it has one, its "ema"."""
    return {(part, k): v for part in ("model", "ema")
            for k, v in (tree.get(part) or {}).items()
            if v.is_floating_point()}


def average_checkpoints(ckpt_path, average_num, max_epoch=0, logger=None):
    """Mean of the last ``average_num`` checkpoints' model states.

    Every floating tensor of the model's state_dict (parameters and
    BatchNorm running statistics, as JAX averages ``params`` and
    ``batch_stats``) and of the EMA where the checkpoints keep one (JAX's
    ``ema_params``) is summed in float64 and cast back to its dtype;
    integer buffers (``num_batches_tracked``), the step, the optimizer and
    the scheduler come from the last checkpoint. With ``max_epoch > 0``
    only checkpoints with step <= max_epoch take part (reference:
    average_ckpt_sr.py:92-96). Returns (averaged checkpoint dict, steps).
    """
    manager = CheckpointManager(ckpt_path)
    steps = manager.all_steps()
    if max_epoch and max_epoch > 0:
        steps = [s for s in steps if s <= max_epoch]
    steps = steps[-average_num:]
    if not steps:
        raise FileNotFoundError("no checkpoints under %s" % ckpt_path)
    if logger:
        logger.info("Averaging checkpoints: %s", steps)

    acc = None
    last = None
    for step in steps:
        tree = manager.restore(step)
        flat = _flat_floats(tree)
        if acc is None:
            acc = {k: v.to(torch.float64) for k, v in flat.items()}
        else:
            if (set(tree["model"]) != set(last["model"])
                    or set(flat) != set(acc)):
                raise ValueError(
                    "checkpoint %s/%d holds other tensors than step %d"
                    % (ckpt_path, step, steps[0]))
            for k in acc:
                acc[k] += flat[k].to(torch.float64)
        last = tree
    n = float(len(steps))
    result = dict(last)
    for part in ("model", "ema"):
        if last.get(part) is not None:
            result[part] = {
                k: ((acc[(part, k)] / n).to(v.dtype)
                    if (part, k) in acc else v)
                for k, v in last[part].items()
            }
    manager.close()
    return result, steps
