"""``chip_smoke.py``'s phase 18 (a rank a card over NCCL) rehearsed on the
CPU, so that a fault in its launches and checks shows here before a multi-card
machine is spent on it.

``chip_smoke.cards_phase`` runs with ``device="cpu"`` at 2 ranks: every
rank an OS process over gloo on the CPU, as the phase launches them on the
card (``--cards-worker``, ``--cards-model-worker``, and the trainers under
``torch.distributed.run``), with ``chip_smoke.CARDS`` shrunk to small
widths and a few utterances. The phase's own checks run: each DP, FSDP,
ring, pipelined and ``model``-axis step against its one-process reference,
the CLI epochs' valid losses on every rank (18e's jobs two waves at a
time, since no card bounds them here), the SIGTERM consensus and F26's
resume within JAX's elastic tolerance, the library epoch against one
process's and its witness. There no kernel launches (the CPU takes every kernel's
plain version), so the phase holds every launch count to 0 here; the
kernels' own checks run on the card only.
"""

import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

torch.set_num_threads(1)

SRF = ["--model-caps-primary-num=8", "--model-caps-primary-dim=4",
       "--model-caps-convolution-num=6", "--model-caps-convolution-dim=4",
       "--model-caps-class-dim=4", "--model-caps-type=naive",
       "--model-caps-context=True", "--model-caps-iter=1",
       "--model-conv-filter-num=8", "--decoding-beam-width=1"]
STF = ["--model-type=stf", "--model-encoder-num=2", "--model-dimension=8",
       "--model-att-head-num=2", "--model-inner-dim=16",
       "--model-conv-filter-num=4", "--model-ap-scale=1",
       "--model-ap-width-zero=1", "--model-ap-width-stripe=1",
       "--model-ap-encoder=True", "--model-ap-decoder=True",
       "--model-ap-encdec=False", "--train-warmup-n=1000",
       "--train-lr-param-k=1.5"]
SMALL = dict(
    chip_smoke.CARDS,
    timit_flags=["--model-encoder-num=3", "--model-caps-window-lpad=1",
                 "--model-caps-window-rpad=1", *SRF],
    cnn_flags=["--model-type=cnn", "--model-conv-is-mp=True",
               "--model-encoder-num=5", "--model-conv-inp-nfilt=8",
               "--model-conv-inn-nfilt=8", "--model-conv-proj-num=1",
               "--model-conv-proj-dim=128", "--model-conv-stride=1",
               "--model-dimension=1", "--tpu-dropout-kernel=pallas",
               "--decoding-beam-width=1"],
    stf_flags=STF + chip_smoke.NO_DROPOUT_FLAGS, stf_cli_flags=STF,
    rows=4, frames=41, timed=1, ring_shape=(2, 2, 16, 4), pipe_batch=4,
    pipe_micro=2,
    cli_utts=(8, 4), cli_frames=(30, 41), cli_bucket=4 * 241, cli_rows=4,
    cli_signal_step=2,
    f26_flags=["--model-type=lstm", "--model-encoder-num=2",
               "--model-dimension=6", "--model-lstm-is-cnnfe=False"],
    wsj_flags=["--model-encoder-num=3", "--model-caps-window-lpad=2",
               "--model-caps-window-rpad=2", *SRF,
               "--train-lr-param-k=0.6"],
    wsj_rows=4, wsj_frames=(30, 41), tp_7c_layers=2, tp_7c_frames=(30, 41),
    epoch_utts=(8, 4), epoch_frames=(30, 41), epoch_batch=2,
    epoch_min_steps=4)


def test_phase_18_holds_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(chip_smoke, "CARDS", SMALL)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    got = chip_smoke.cards_phase(torch, "CPU rehearsal", device="cpu",
                                 world=2)
    out = capsys.readouterr().out
    for stage in ("18a DP", "18a CNN-TIMIT DP", "18b FSDP", "18c ring",
                  "18d 2 stages", "18e example", "18e batch", "18e whole",
                  "18e stf",
                  "18e SIGTERM", "18f (1, 2)", "18f (2, 1)", "18f 7c",
                  "18g witness", "18g SRF-WSJ epoch"):
        assert stage in out, stage
    # no kernel runs on the CPU: every path's launches are 0
    assert not any(v for k in ("k1", "k2", "k5") for v in got[k].values())
    assert set(got["tp_persistent"]) == {"1x2", "7c_bf16", "7c_stream",
                                         "epoch"}
