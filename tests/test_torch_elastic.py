"""Elastic resume in the port: ``python -m srf_tpu_torch.trainer_sr``
killed or stopped on one world size and resumed on another, as JAX's
``tests/test_elastic.py`` resumes on a resized mesh (the port's mesh is
one process per card, so its data axis is the process count). The ranks
run over gloo on the CPU (``tests/_torch_dist_worker.py``: ``ELASTIC``
holds the two scenarios), on the 14-utterance corpus of
``tests/test_torch_trainer_cli.py`` and a small LSTM without dropout (the
port's step folds the rank into its dropout seed, F22, so only a
dropout-free step is the same on every world size) and with
``--tpu-data-shard=batch``:

- killed mid-epoch on 2 ranks, resumed mid-epoch by one process;
- epoch 1 on one process, epoch 2 on 2 ranks from its checkpoint;

each ending within JAX's elastic tolerance (rtol 2e-4, atol 1e-6) of the
uninterrupted run. And a mid-epoch checkpoint written under another batch
geometry (one process at batch 3, resumed on 2 ranks, where the batch
rounds to 2) is refused: the run restarts the epoch from the epoch
checkpoint, and the refused checkpoint is replaced by the resumed run's
own, under its own geometry.
"""

import sys

import numpy as np
import pytest
import torch

from srf_tpu_torch.tools import save_tfrecord
from srf_tpu_torch.utils import checkpoint

from _torch_dist_worker import ELASTIC_FLAGS, run_elastic, run_trainer
from test_torch_trainer_cli import _argv, _make_corpus

torch.set_num_threads(1)

TRAINER = [sys.executable, "-m", "srf_tpu_torch.trainer_sr"]
# a unidirectional LSTM of width 6 on the raw features: no dropout site and
# no BatchNorm
LSTM = ("--model-type=lstm", "--model-dimension=6",
        "--model-lstm-is-cnnfe=False", "--train-inp-dropout=0",
        "--train-inn-dropout=0")
# JAX's elastic tolerance (tests/test_elastic.py)
RTOL, ATOL = 2e-4, 1e-6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("elastic")
    _make_corpus(base)
    save_tfrecord.main(_argv(base))
    return base


def _command(corpus, *extra):
    return TRAINER + _argv(corpus, *LSTM, *extra)[1:]


def _model(ckpt, step):
    return checkpoint.CheckpointManager(str(ckpt)).restore(step)["model"]


def _assert_same_weights(got, want):
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value.numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=key)


@pytest.mark.parametrize("scenario", ["mid_2_to_1", "epoch_1_to_2"])
def test_resume_on_another_world_size(corpus, tmp_path, scenario):
    ckpt, reference = tmp_path / "ckpt", tmp_path / "reference"
    runs = run_elastic(scenario, _command(corpus), ckpt, reference)
    resumed = runs[-1]
    if scenario == "mid_2_to_1":
        assert all("FAULT INJECTION" in err for _, err in runs[0])
        # 10 utterances at a global batch of 2: 5 steps an epoch; the last
        # mid checkpoint before step 8 is epoch 2's batch 2 (step 7)
        assert "Resuming mid-epoch" in resumed[0][1]
        assert "epoch 1, batch 2" in resumed[0][1]
    else:
        assert all("Resuming mid-epoch" not in err for _, err in resumed)
        assert all("2-way data parallel" in err or "global 2 = 1/process"
                   in err for _, err in resumed)
    assert "Ignoring mid-epoch" not in "".join(e for _, e in resumed)
    want, got = _model(reference, 2), _model(ckpt, 2)
    _assert_same_weights(got, want)
    assert (checkpoint.CheckpointManager(str(ckpt)).restore(2)["step"]
            == checkpoint.CheckpointManager(str(reference)).restore(2)["step"]
            == 10)


def test_mid_checkpoint_of_another_batch_geometry_is_refused(corpus,
                                                              tmp_path):
    ckpt = tmp_path / "ckpt"
    command = _command(corpus, "--path-ckpt=%s" % ckpt, *ELASTIC_FLAGS,
                       "--train-batch-size=3", "--train-max-epoch=2",
                       "--tpu-ckpt-every-steps=2")
    # one process at batch 3: 3 steps an epoch; killed at step 5 after the
    # mid checkpoint of epoch 2's batch 2
    run_trainer(command + ["--tpu-fault-at-step=5"], 1, expect_rc=42)
    mid = checkpoint.CheckpointManager(str(ckpt / "mid"))
    assert mid.restore(mid.latest_step())["resume"]["batch_sig"] == 3.0
    # on 2 ranks the batch rounds to 2 = 1/process x 2 processes
    outs = run_trainer(command, 2)
    for _, err in outs:
        assert "Ignoring mid-epoch checkpoint" in err
        assert "different batch geometry" in err
        assert "Resuming mid-epoch" not in err
    # epoch 2 ran whole from the epoch-1 checkpoint (3 steps), 5 steps
    assert checkpoint.CheckpointManager(str(ckpt)).restore(2)["step"] == 8
    # the refused checkpoint was purged; the latest is the resumed run's
    mid = checkpoint.CheckpointManager(str(ckpt / "mid"))
    meta = mid.restore(mid.latest_step())["resume"]
    assert meta["batch_sig"] == 2.0 and meta["epoch"] == 1
