"""``python -m srf_tpu_torch.trainer_sr`` as two ranks over gloo (the
``SRF_*`` variables, ``--device=cpu``), on a 14-utterance corpus and the
verify skill's small SRF:

- a 2-rank run of 2 epochs (global batch 2, one row a rank, example
  sharding with the lockstep schedule): both ranks log the same global
  losses, only rank 0 writes ``metrics.jsonl`` and the checkpoints, and the
  checkpoint is the one-process file (it loads into one process);
- a SIGTERM raised on rank 1 alone (``--tpu-fault-signal-process=1``)
  at step 7: the ranks agree at the next consensus point (the mid
  checkpoint after epoch 2's 4th batch, step 9), both save that mid
  checkpoint and exit 143; the rerun (with ``--tpu-async-ckpt``) resumes
  there and ends with the uninterrupted run's weights (atol 1e-6).
"""

import re
import sys

import numpy as np
import pytest
import torch

from srf_tpu_torch.models.registry import build_model
from srf_tpu_torch.config import ParseOption
from srf_tpu_torch.tools import save_tfrecord
from srf_tpu_torch.utils import checkpoint

from _torch_dist_worker import launch
from test_torch_trainer_cli import QUIET, _argv, _make_corpus

torch.set_num_threads(1)

TRAINER = [sys.executable, "-m", "srf_tpu_torch.trainer_sr"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("preempt_dist")
    _make_corpus(base)
    save_tfrecord.main(_argv(base))
    return base


def _flags(corpus, ckpt, *extra):
    return _argv(corpus, "--path-ckpt=%s" % ckpt, "--train-max-epoch=2",
                 "--tpu-ckpt-every-steps=2", *extra)[1:]


def _valid_losses(err):
    return re.findall(r"Epoch (\d+) Valid Loss ([0-9.]+)", err)


@pytest.fixture(scope="module")
def uninterrupted(corpus, tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("whole") / "ckpt"
    outs = launch(TRAINER + _flags(corpus, ckpt))
    return ckpt, outs


def test_two_rank_epochs(corpus, uninterrupted):
    ckpt, outs = uninterrupted
    losses = [_valid_losses(err) for _, err in outs]
    assert len(losses[0]) == 2 and losses[0] == losses[1]
    assert "2-way data parallel" in outs[0][1]
    assert "global 2 = 1/process x 2 processes" in outs[1][1]
    records = (ckpt / "metrics.jsonl").read_text().splitlines()
    assert len(records) == 4  # rank 0's alone: 2 epochs x (train, valid)
    manager = checkpoint.CheckpointManager(str(ckpt))
    assert manager.all_steps() == [1, 2]
    tree = manager.restore(2)
    # 10 utterances, 5 a rank, one a step
    assert tree["step"] == 10
    config = ParseOption(["prog"] + _flags(corpus, ckpt), QUIET,
                         is_print_opts=False).args
    model, _ = build_model(config, 8)  # 7 tokens and the blank
    model.load_state_dict(tree["model"])  # the one-process layout
    assert all(torch.isfinite(v).all() for v in tree["model"].values()
               if v.is_floating_point())


def test_sigterm_on_one_rank_stops_both_and_the_rerun_resumes(
        corpus, uninterrupted, tmp_path):
    ckpt = tmp_path / "ckpt"
    outs = launch(TRAINER + _flags(corpus, ckpt, "--tpu-async-ckpt=True",
                                   "--tpu-fault-signal-at-step=7",
                                   "--tpu-fault-signal-process=1"),
                  expect_rc=143)
    assert "raising SIGTERM" in outs[1][1]
    assert "raising SIGTERM" not in outs[0][1]
    assert all("SIGTERM: saved mid-epoch checkpoint at global step 9"
               in err for _, err in outs)
    mid = checkpoint.CheckpointManager(str(ckpt / "mid"))
    assert mid.all_steps() == [7, 9]
    assert mid.restore(9)["resume"]["batch_index"] == 4
    outs = launch(TRAINER + _flags(corpus, ckpt, "--tpu-async-ckpt=True"))
    assert all("Resuming mid-epoch" in err and "epoch 1, batch 4" in err
               for _, err in outs)
    whole = checkpoint.CheckpointManager(str(uninterrupted[0])).restore(2)
    resumed = checkpoint.CheckpointManager(str(ckpt)).restore(2)
    assert resumed["step"] == whole["step"] == 10
    for key, value in whole["model"].items():
        np.testing.assert_allclose(resumed["model"][key].numpy(),
                                   value.numpy(), rtol=0, atol=1e-6,
                                   err_msg=key)
