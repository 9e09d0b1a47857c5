"""MWER fine-tuning in the port (``srf_tpu_torch/train/mwer.py`` and
``train/losses.py``) against ``srf_tpu/train/mwer.py`` and
``srf_tpu/train/losses.py``:

- ``loss_ewerr``, ``loss_ce`` (neighbour and label smoothing), ``ppl`` and
  ``loss_function_w2v`` on the same numpy inputs, within 1e-6 relative
  (float32 sums in other orders; measured up to 1.0e-7);
- ``utils/edit_distance``'s ``compute_wer``, ``assemble_to_words``,
  ``wer_tokens`` and ``levenshtein`` equal JAX's;
- ``decode_nbest``: ids and lengths equal JAX's on the same logits, with a
  beam too thin for the n-best (the best hypothesis duplicated) and a
  ``pad_to`` that truncates; ``hypothesis_errors`` equal;
- one MWER update of a small SRF with BatchNorm (B 4, n-best 3, beam 8,
  lambda-CTC 0.1) at accum 1 and 2 against JAX's
  ``make_mwer_train_step``, dropout off, both sides scoring the same
  hypotheses (JAX's n-best, recorded and handed to the port's step; the
  decodes themselves are compared above). SGD at rate 1 makes each update
  minus its summed gradient: ``loss_sum`` within rtol 1e-5 and every
  gradient within 1e-4 of its largest entry (``test_torch_train.py``'s
  tolerances; measured 3.6e-7 and up to 5.4e-6).
"""

import numpy as np
import pytest

import flax
import jax
import jax.numpy as jnp
import optax
import torch

from srf_tpu.models.srf import SequenceRouter as FlaxSequenceRouter
from srf_tpu.train import losses as jax_losses
from srf_tpu.train import mwer as jax_mwer
from srf_tpu.train import step as jax_step
from srf_tpu.train.state import TrainState as JaxTrainState
from srf_tpu_torch import convert
from srf_tpu_torch.config.constants import Constants
from srf_tpu_torch.models.srf import SequenceRouter
from srf_tpu_torch.train import losses, mwer, step
from srf_tpu_torch.train.state import TrainState

from _torch_parity import flatten_tree, no_dropout, random_flax_variables

torch.set_num_threads(1)

FEAT_DIM, CLASS_N, IN_LEN_DIV = 40, 8, 4
MODEL = dict(
    feat_dim=FEAT_DIM, class_n=CLASS_N, enc_num=2, caps_primary_num=8,
    caps_primary_dim=4, caps_conv_num=6, caps_conv_dim=4, caps_class_dim=4,
    caps_iter=1, lpad=1, rpad=1, is_context=True, conv_layer_num=2,
    conv_filter_num=8, caps_type="naive", inp_dropout=0.0, inn_dropout=0.0,
)


def _close(got, want, rtol=1e-6):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def test_losses_match_jax():
    rng = np.random.RandomState(0)
    errors = rng.randint(0, 6, size=(3, 4)).astype(np.float32)
    lprobs = (rng.randn(3, 4) * 30 - 120).astype(np.float32)
    _close(losses.loss_ewerr(torch.from_numpy(errors),
                             torch.from_numpy(lprobs)),
           jax_losses.loss_ewerr(jnp.asarray(errors), jnp.asarray(lprobs)))
    labels = rng.randint(0, 9, size=(3, 7)).astype(np.int32)
    logits = rng.randn(3, 7, 9).astype(np.float32)
    for kind in (Constants.SM_NEIGHBOR, Constants.SM_LABEL):
        for confidence in (0.9, 1.0):
            _close(losses.loss_ce(kind, torch.from_numpy(labels),
                                  torch.from_numpy(logits), confidence, 9),
                   jax_losses.loss_ce(kind, jnp.asarray(labels),
                                      jnp.asarray(logits), confidence, 9))
    assert losses.loss_ce("none", torch.from_numpy(labels),
                          torch.from_numpy(logits), 0.9, 9) is None
    seq_len = np.array([7, 3, 0], np.int32)
    _close(losses.ppl(torch.from_numpy(labels), torch.from_numpy(logits),
                      torch.from_numpy(seq_len)),
           jax_losses.ppl(jnp.asarray(labels), jnp.asarray(logits),
                          jnp.asarray(seq_len)))
    real = rng.randint(0, 2, size=(5, 6))
    pred = (rng.randn(5, 6) * 3).astype(np.float32)
    weights = rng.rand(5).astype(np.float32)
    for smoothing in (0.0, 0.1):
        _close(losses.loss_function_w2v(torch.from_numpy(real),
                                        torch.from_numpy(pred),
                                        torch.from_numpy(weights), smoothing),
               jax_losses.loss_function_w2v(jnp.asarray(real),
                                            jnp.asarray(pred),
                                            jnp.asarray(weights), smoothing))


@pytest.mark.parametrize("beam,n_best,pad_to", [(8, 3, None), (2, 4, None),
                                                (8, 3, 2)])
def test_decode_nbest_and_errors_equal_jax(beam, n_best, pad_to):
    rng = np.random.RandomState(beam + n_best)
    logits = (rng.randn(3, 12, 6) * 3).astype(np.float32)
    lens = np.array([12, 7, 1], np.int32)
    got = mwer.decode_nbest(logits, lens, beam, n_best, 5, pad_to=pad_to)
    want = jax_mwer.decode_nbest(logits, lens, beam, n_best, 5,
                                 pad_to=pad_to)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    if beam < n_best:  # the thin beam repeats its best hypothesis
        assert (got[0][:, -1] == got[0][:, 0]).all()
    labels = rng.randint(0, 5, size=(3, 4)).astype(np.int32)
    tar_len = np.array([4, 2, 0], np.int32)
    np.testing.assert_array_equal(
        mwer.hypothesis_errors(labels, tar_len, *got),
        jax_mwer.hypothesis_errors(labels, tar_len, *want))


def _batch():
    rng = np.random.RandomState(5)
    lens = np.array([40, 31, 36, 26], np.int32)
    tar_len = np.array([4, 3, 3, 2], np.int32)
    return {
        "feats": rng.randn(4, 40, FEAT_DIM).astype(np.float32),
        "labels": rng.randint(1, CLASS_N - 1, size=(4, 4)).astype(np.int32),
        "inp_len": lens, "tar_len": tar_len,
    }


@pytest.mark.parametrize("accum", [1, 2])
def test_mwer_update_matches_jax(monkeypatch, accum):
    monkeypatch.setattr(flax.linen.Dropout, "__call__",
                        lambda self, inputs, deterministic=None, rng=None:
                        inputs)
    flax_model = FlaxSequenceRouter(**MODEL)
    variables = random_flax_variables(flax_model, FEAT_DIM, seed=8)
    batch = _batch()
    kwargs = dict(beam_width=8, n_best=3, blank_id=CLASS_N - 1, lam_ctc=0.1,
                  accum_steps=accum)

    decoded = []
    jax_decode = jax_mwer.decode_nbest

    def recording(*args, **kw):
        decoded.append(jax_decode(*args, **kw))
        return decoded[-1]

    monkeypatch.setattr(jax_mwer, "decode_nbest", recording)
    params = jax.tree.map(jnp.asarray, variables["params"])
    tx = optax.sgd(1.0)
    jax_apply = jax_step.make_apply_fn(flax_model)
    jax_train = jax_mwer.make_mwer_train_step(
        jax_apply, jax_step.make_logits_fn(jax_apply), tx, IN_LEN_DIV,
        **kwargs)
    jax_state, jax_metrics = jax_train(
        JaxTrainState.create(params, tx, jax.tree.map(
            jnp.asarray, variables["batch_stats"])),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    jax_grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             params, jax_state.params)

    model = no_dropout(SequenceRouter(**MODEL))
    model.load_state_dict(convert.flax_to_state_dict(variables))
    state = TrainState.create(
        model, torch.optim.SGD(model.parameters(), lr=1.0), device="cpu")
    port_decode = mwer.decode_nbest
    port_hyps = []

    def jax_hypotheses(*args, **kw):
        port_hyps.append(port_decode(*args, **kw))
        return decoded[-1]

    monkeypatch.setattr(mwer, "decode_nbest", jax_hypotheses)
    apply_fn = step.make_apply_fn(model)
    train_step = mwer.make_mwer_train_step(
        apply_fn, step.make_logits_fn(apply_fn), IN_LEN_DIV, **kwargs)
    state, metrics = train_step(
        state, {k: torch.from_numpy(v) for k, v in batch.items()}, 3)
    assert state.step == 1 and metrics["samples"].item() == 4.0
    # the port's own n-best of its eval logits is JAX's here too
    for g, w in zip(port_hyps[0], decoded[0]):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_allclose(metrics["loss_sum"].item(),
                               float(jax_metrics["loss_sum"]), rtol=1e-5)
    grads = flatten_tree(convert.state_dict_to_flax(
        {n: p.grad for n, p in model.named_parameters()})["params"])
    want = flatten_tree(jax_grads)
    assert sorted(grads) == sorted(want)
    for key in want:
        np.testing.assert_allclose(grads[key], want[key], rtol=0,
                                   atol=1e-4 * np.abs(want[key]).max(),
                                   err_msg=key)


def test_word_error_helpers_equal_jax():
    """``compute_wer`` (the reference's clean-up chain and word-level
    Levenshtein), ``wer_tokens`` and ``levenshtein`` against JAX's."""
    from srf_tpu.utils import edit_distance as jax_edit
    from srf_tpu_torch.utils import edit_distance

    vocab = ["p", "a", "b", " ", "n", "@", "$", "c", "@@ "]
    rng = np.random.RandomState(4)
    hyp = rng.randint(0, len(vocab), size=(5, 12))
    ref = rng.randint(0, len(vocab), size=(5, 10))
    for got, want in zip(edit_distance.compute_wer(hyp, ref, vocab),
                         jax_edit.compute_wer(hyp, ref, vocab)):
        np.testing.assert_array_equal(got, want)
    words = [edit_distance.assemble_to_words(ids, vocab) for ids in hyp]
    assert words == [jax_edit.assemble_to_words(ids, vocab) for ids in hyp]
    assert edit_distance.wer_tokens(words[0], words[1]) == \
        jax_edit.wer_tokens(words[0], words[1])
    assert edit_distance.levenshtein([1, 2, 3], [1, 3]) == 1
