"""The port's process bootstrap and multi-process data layer
(``parallel/distributed.py``, ``device.py``, ``data/loader.py``,
``utils/checkpoint.py``) against srf_tpu's.

- ``maybe_initialize``: nothing without the environment; the
  ``SRF_COORDINATOR`` / ``SRF_NUM_PROCESSES`` / ``SRF_PROCESS_ID``
  variables start a ``tcp://`` group of that size and rank, ``SRF_MULTIHOST``
  torchrun's ``env://``; idempotent; NCCL (a CUDA device) on a host
  without that card raises instead of taking gloo;
- ``resolve_device`` takes the rank's card in a world of several ranks
  and raises where the host has none for it;
- on two real ranks over gloo (``_torch_dist_worker.py``), both loader
  modes for 2 epochs: ``global_sync`` (example shards, lengths
  all-gathered once) emits exactly JAX's ``plan_lockstep_epoch`` schedule
  on each rank, ``shard_batches`` exactly JAX's ``BucketedLoader`` slices,
  and ``batch_shapes`` the per-rank division;
- ``--tpu-async-ckpt``: the file written in the background equals the
  synchronous one after ``wait()``, though the state changed meanwhile;
- ``tools/dist_probe.py`` refuses to start without a card.
"""

import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

from srf_tpu.data import loader as jax_loader
from srf_tpu_torch import device as port_device
from srf_tpu_torch.data.example_proto import encode_example
from srf_tpu_torch.data.tfrecord import TFRecordWriter
from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.utils.checkpoint import CheckpointManager

from _torch_dist_worker import run_scenario

torch.set_num_threads(1)

FEAT_DIM = 5
BOUNDARIES, BATCH_SIZES = [20, 35, 50], [4, 4, 2, 2]  # global sizes


@pytest.fixture
def no_env(monkeypatch):
    for name in ("SRF_COORDINATOR", "SRF_MULTIHOST", "SRF_NUM_PROCESSES",
                 "SRF_PROCESS_ID", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def _fake_init(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, "host_group", lambda: None)
    return calls


def test_no_env_is_noop(no_env):
    calls = _fake_init(no_env)
    assert distributed.maybe_initialize() is False
    assert calls == []
    assert (distributed.rank(), distributed.world_size()) == (0, 1)


def test_coordinator_env_starts_a_tcp_group(no_env):
    calls = _fake_init(no_env)
    no_env.setenv("SRF_COORDINATOR", "10.0.0.1:1234")
    no_env.setenv("SRF_NUM_PROCESSES", "4")
    no_env.setenv("SRF_PROCESS_ID", "2")
    assert distributed.maybe_initialize(device="cpu") is True
    assert calls == [{"backend": "gloo", "init_method": "tcp://10.0.0.1:1234",
                      "world_size": 4, "rank": 2}]


def test_multihost_flag_reads_torchrun_env(no_env):
    calls = _fake_init(no_env)
    no_env.setenv("SRF_MULTIHOST", "1")
    assert distributed.maybe_initialize(device="cpu", backend="gloo") is True
    assert calls == [{"backend": "gloo", "init_method": "env://"}]


def test_initialized_group_is_kept(no_env):
    calls = _fake_init(no_env)
    no_env.setenv("SRF_COORDINATOR", "10.0.0.1:1234")
    no_env.setattr(dist, "is_initialized", lambda: True)
    assert distributed.maybe_initialize() is True
    assert calls == []


def test_nccl_without_the_card_raises(no_env):
    """A CUDA device means NCCL; without the card the start raises rather
    than taking gloo."""
    calls = _fake_init(no_env)
    no_env.setenv("SRF_COORDINATOR", "10.0.0.1:1234")
    no_env.setenv("SRF_NUM_PROCESSES", "2")
    no_env.setenv("SRF_PROCESS_ID", "1")
    no_env.setattr(torch.cuda, "is_available", lambda: False)
    assert distributed.default_backend("cuda") == "nccl"
    with pytest.raises(RuntimeError, match="wants cuda:1 but this host has 0"):
        distributed.maybe_initialize()
    assert calls == []


def test_resolve_device_takes_the_ranks_card(no_env):
    no_env.setattr(torch.cuda, "is_available", lambda: True)
    no_env.setattr(torch.cuda, "device_count", lambda: 1)
    no_env.setattr(distributed, "world_size", lambda group=None: 2)
    no_env.setattr(distributed, "rank", lambda group=None: 1)
    with pytest.raises(RuntimeError, match="rank 1 wants cuda:1"):
        port_device.resolve_device("cuda")
    no_env.setenv("LOCAL_RANK", "0")  # two ranks on one card
    assert port_device.resolve_device(None) == torch.device("cuda", 0)
    assert port_device.resolve_device("cuda:0") == torch.device("cuda", 0)
    assert port_device.resolve_device("cpu") == torch.device("cpu")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist_loader")
    rng = np.random.RandomState(1)
    writers = [TFRecordWriter(str(base / ("split-%d" % s))) for s in range(2)]
    for i in range(41):
        frames = int(rng.randint(8, 64))
        labels = rng.randint(1, 40, size=max(2, frames // 6))
        writers[i % 2].write(encode_example({
            "target_label": labels.astype(np.int64),
            "input_speech": rng.randn(frames, FEAT_DIM).astype(
                np.float32).flatten(),
            "input_length": np.asarray([frames], np.int64),
            "target_length": np.asarray([labels.size], np.int64),
            "utt_id": [("u%02d" % i).encode()],
        }))
    for writer in writers:
        writer.close()
    spec = {"pattern": "split-*", "feat_dim": FEAT_DIM,
            "boundaries": BOUNDARIES, "batch_sizes": BATCH_SIZES}
    np.savez(base / "inputs.npz", spec=json.dumps(spec))
    return base, run_scenario("loader", base)


def test_global_sync_is_jax_lockstep_schedule(corpus):
    base, ranks = corpus
    pattern = str(base / "split-*")
    shards = [jax_loader.SpeechDataset(pattern, FEAT_DIM, with_utt_id=True,
                                       process_index=p, process_count=2)
              for p in range(2)]
    local = [bs // 2 for bs in BATCH_SIZES]
    # the static label caps from the whole corpus, as the gathered lengths
    # give them
    caps = jax_loader.BucketedLoader(
        jax_loader.SpeechDataset(pattern, FEAT_DIM), BOUNDARIES, local,
        prefetch=0).label_caps
    for epoch in range(2):
        emissions = jax_loader.plan_lockstep_epoch(
            [(ds.inp_lens, ds.lab_lens) for ds in shards], BOUNDARIES, local,
            caps, 7, epoch, True)
        assert len(emissions[0]) > 4
        for p, ds in enumerate(shards):
            want = ["|".join(ds.utt_ids[i] for i in idxs)
                    for _, idxs in emissions[p]]
            assert list(ranks[p]["global_sync/%d/ids" % epoch]) == want
            # every rank's step has its bucket's static shape
            shapes = ranks[p]["global_sync/%d/shapes" % epoch]
            assert [tuple(s[:1]) for s in shapes] == [
                (local[b],) for b, _ in emissions[p]]
    assert [s[0] for s in ranks[0]["global_sync/batch_shapes"]] == local


def test_shard_batches_is_jax_batch_slicing(corpus):
    base, ranks = corpus
    ds = jax_loader.SpeechDataset(str(base / "split-*"), FEAT_DIM,
                                  with_utt_id=True)
    for p in range(2):
        want_loader = jax_loader.BucketedLoader(
            ds, BOUNDARIES, BATCH_SIZES, shuffle=True, seed=7, prefetch=0,
            shard_batches=True, process_index=p, process_count=2)
        for epoch in range(2):
            want_loader.set_epoch(epoch)
            want = ["|".join(b["utt_ids"]) for b in want_loader]
            assert want
            assert list(ranks[p]["shard_batches/%d/ids" % epoch]) == want
        assert [tuple(s) for s in ranks[p]["shard_batches/batch_shapes"]] \
            == [tuple(s) for s in want_loader.batch_shapes()]


def test_async_checkpoint_equals_the_synchronous_one(tmp_path):
    torch.manual_seed(0)
    model = torch.nn.Linear(64, 32)
    tree = {"step": 3, "model": model.state_dict()}
    CheckpointManager(str(tmp_path / "sync")).save(3, tree)
    manager = CheckpointManager(str(tmp_path / "async"), use_async=True)
    manager.save(3, tree)
    with torch.no_grad():  # the next step changes the state in place
        model.weight.add_(1.0)
    manager.wait()
    sync = CheckpointManager(str(tmp_path / "sync")).restore(3)
    got = manager.restore(3)
    assert got["step"] == 3
    for key, value in sync["model"].items():
        assert torch.equal(got["model"][key], value), key
    assert not torch.equal(got["model"]["weight"], model.weight.detach())
    manager.close()


def test_dist_probe_needs_the_card(monkeypatch):
    """``tools/dist_probe.py`` reports which operations gloo and NCCL run on
    CUDA tensors; without a card it refuses to start."""
    from srf_tpu_torch.tools import dist_probe

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        dist_probe.main([])
    names = [op.__name__ for op in dist_probe._ops(dist, 0, 2, "cuda")]
    assert names == ["broadcast", "all_reduce", "all_gather",
                     "all_gather_into_tensor", "reduce_scatter_tensor",
                     "batch_isend_irecv", "fsdp2"]
