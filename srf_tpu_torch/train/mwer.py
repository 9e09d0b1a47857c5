"""MWER (minimum word error rate) fine-tuning, ``--train-is-mwer`` (port
of ``srf_tpu/train/mwer.py``).

The reference ships ``loss_ewerr`` but never wires it into a trainer; the
JAX package makes it a fine-tune mode, and so does the port:

1. decode an n-best list per utterance under the current weights with the
   merged-prefix CTC beam on the host (``ops/ctc_decode.prefix_beam_search``
   with ``top_paths=N``, the search JAX calls): :func:`decode_nbest`;
2. each hypothesis' token edit distance to the reference, on the host:
   :func:`hypothesis_errors`;
3. score the N hypotheses under the current model as CTC
   log-probabilities (one ``F.ctc_loss`` over B·N rows: the logits
   repeated N times, the lengths on the host, as ``ops/ctc.py`` takes
   them), renormalise over the beam and take the expected error
   (``train/losses.loss_ewerr``);
4. add ``lam_ctc`` times the reference's CTC loss, both summed over the
   examples and divided by the global batch, and accumulate over
   microbatches as the plain step does (``--tpu-grad-accum``).

The step matches the train loop's ``train_step(state, batch, seed)``
contract, so ``run_training`` drives MWER epochs unchanged (the valid loss
stays plain CTC). It moves no EMA, as in JAX (``trainer_sr`` warns).

Data-parallel (``group``): each rank n-best-decodes only its own rows
(JAX's ``_process_local_rows``), both loss terms are divided by the global
batch, and the gradients and metrics are summed over the group, as in
``train/step.py``.
"""

import numpy as np
import torch

from srf_tpu_torch.ops.ctc import ctc_loss_from_frames
from srf_tpu_torch.train.losses import loss_ewerr
from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.train.step import (
    all_reduce_gradients, global_count, microbatches, optimizer_update,
    reduce_metrics, step_seed,
)
from srf_tpu_torch.utils.edit_distance import levenshtein


def decode_nbest(logits, logit_lens, beam_width, n_best, blank_id,
                 pad_to=None):
    """Host n-best decode: (hyps [B, N, L], hyp_lens [B, N]) int32.

    ``pad_to`` fixes the hypothesis axis (longer hypotheses are
    truncated). A beam with fewer than N hypotheses is padded with copies
    of its best one, which weighs the best twice in the beam's softmax: a
    bias toward the model's top path on short or confident utterances, as
    JAX has it."""
    from srf_tpu_torch.ops.ctc_decode import prefix_beam_search

    logits = np.asarray(logits)
    all_hyps = []
    max_len = 1
    for b in range(logits.shape[0]):
        nbest = prefix_beam_search(
            logits[b], int(logit_lens[b]), beam_width=beam_width,
            blank_id=blank_id, top_paths=n_best)
        hyps = [ids for ids, _ in nbest]
        while len(hyps) < n_best:
            hyps.append(list(hyps[0]) if hyps else [])
        all_hyps.append(hyps)
        max_len = max(max_len, *(len(h) for h in hyps))
    width = pad_to if pad_to is not None else max_len
    out = np.zeros((logits.shape[0], n_best, width), np.int32)
    lens = np.zeros((logits.shape[0], n_best), np.int32)
    for b, hyps in enumerate(all_hyps):
        for n, h in enumerate(hyps):
            h = h[:width]
            out[b, n, :len(h)] = h
            lens[b, n] = len(h)
    return out, lens


def hypothesis_errors(labels, tar_len, hyps, hyp_lens):
    """[B, N] float32 token edit distances of each hypothesis to the
    reference ``labels[b, :tar_len[b]]``."""
    labels = np.asarray(labels)
    tar_len = np.asarray(tar_len)
    batch, n_best = hyps.shape[:2]
    errors = np.zeros((batch, n_best), np.float32)
    for b in range(batch):
        ref = [int(x) for x in labels[b, :int(tar_len[b])]]
        for n in range(n_best):
            hyp = [int(x) for x in hyps[b, n, :int(hyp_lens[b, n])]]
            errors[b, n] = levenshtein(ref, hyp)
    return errors


def _host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def make_mwer_train_step(apply_fn, logits_fn, in_len_div, beam_width,
                         n_best, blank_id, lam_ctc=0.1, accum_steps=1,
                         group=None):
    """Returns ``train_step(state, batch, seed) -> (state, metrics)``
    running one MWER update (``batch`` and ``metrics`` as
    ``train/step.make_train_step``'s; ``loss_sum`` is the expected error
    plus ``lam_ctc`` times the CTC loss, summed over the examples).

    The n-best comes from ``logits_fn(state, batch)`` (the eval-mode
    forward, ``train/step.make_logits_fn``), read back to the host: the
    step waits for it. Hypotheses are padded to the batch's label width
    plus 8. ``accum_steps`` splits the update into microbatches (the
    scoring forward's N + 1 CTC lattices per example are the heavy part);
    the decode stays whole. ``group``: the module docstring."""
    generators = {}

    def train_step(state, batch, seed):
        feats = batch["feats"]
        logits = logits_fn(state, batch)
        inp_len = _host(batch["inp_len"])
        host_logits = logits.float().cpu().numpy()
        logit_lens = np.minimum(np.maximum(1, -(-inp_len // in_len_div)),
                                host_logits.shape[1])
        hyps, hyp_lens = decode_nbest(
            host_logits, logit_lens, beam_width, n_best, blank_id,
            pad_to=int(batch["labels"].shape[1]) + 8)
        errors = hypothesis_errors(_host(batch["labels"]),
                                   _host(batch["tar_len"]), hyps, hyp_lens)

        if feats.device not in generators:
            generators[feats.device] = torch.Generator(feats.device)
        generator = generators[feats.device]
        generator.manual_seed(step_seed(
            seed, state.step, distributed.rank(group) if group else 0))
        global_batch = global_count(feats.shape[0], feats.device, group)
        full = dict(batch, hyps=hyps, hyp_lens=hyp_lens, errors=errors)
        state.optimizer.zero_grad(set_to_none=True)
        loss_sum = None
        for mb in microbatches(full, accum_steps):
            mb_logits = apply_fn(mb, True, generator)
            rows, frames, classes = mb_logits.shape
            # [b, N]: -log p of each hypothesis, one CTC over b * N rows
            mb_hyps = torch.as_tensor(mb["hyps"]).to(feats.device)
            pe = ctc_loss_from_frames(
                mb_logits[:, None].expand(rows, n_best, frames, classes)
                .reshape(rows * n_best, frames, classes),
                torch.as_tensor(np.repeat(_host(mb["inp_len"]), n_best)),
                in_len_div, mb_hyps.reshape(rows * n_best, -1),
                torch.as_tensor(mb["hyp_lens"].reshape(-1)),
            ).reshape(rows, n_best)
            ew = loss_ewerr(torch.as_tensor(mb["errors"]).to(feats.device),
                            -pe)
            ctc_ref = ctc_loss_from_frames(mb_logits, mb["inp_len"],
                                           in_len_div, mb["labels"],
                                           mb["tar_len"])
            part = ew.sum() + lam_ctc * ctc_ref.sum()
            (part / global_batch).backward()
            part = part.detach()
            loss_sum = part if loss_sum is None else loss_sum + part
        if group is not None:
            all_reduce_gradients(state.model, group)
        optimizer_update(state)
        metrics = {
            "loss_sum": loss_sum,
            "samples": global_batch,
            "frames": torch.as_tensor(inp_len).to(feats.device).sum()
                      .float(),
        }
        return state, reduce_metrics(metrics, group, ("loss_sum", "frames"))

    return train_step
