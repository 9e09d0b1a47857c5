"""Decode loop (port of the decode part of ``srf_tpu/train/loop.py``).

Decode mode (``--train-max-epoch=0``): CTC beam search over the test split,
emitting ``UTTID: ["<id>"]`` + a sparse-values line compatible with the
reference's log2utt scrapers (reference: trainer_sr.py:96-117,
log2utt.py:78-93). The training loop is not ported yet.
"""

import time

import numpy as np
import torch

from srf_tpu_torch.ops.ctc_decode import beam_search_batch

STEP_KEYS = ("feats", "labels", "inp_len", "tar_len")


def run_decoding(config, logger, state, logits_fn, test_loader, in_len_div,
                 beam_width=None, decode_impl=None):
    """Decode and print hypotheses in the reference's scrape-able format.

    ``logits_fn(state, batch)`` returns the batch's logits [B, T', V] (a
    tensor on the model's device, or numpy). ``decode_impl``: "device" (the
    beam on the logits' device, ops/ctc_beam.py; the default), "host" (the
    C++ prefix beam, or the Python one when an LM is fused or the C++
    library is unavailable), or "greedy".
    """
    beam_width = beam_width or config.decoding_beam_width or 100
    decode_impl = decode_impl or getattr(config, "tpu_decode_impl", "device")
    from srf_tpu_torch.ops.ngram_lm import load_lm_from_config

    lm = load_lm_from_config(config, logger)
    if lm is not None and decode_impl == "greedy":
        logger.warning(
            "--tpu-lm-path is ignored by greedy decoding; use the device "
            "or host beam (--tpu-decode-impl)"
        )
    device_lm = None  # the device beam's LM, its table on the logits' device
    prev = time.time()
    for batch in test_loader:
        logits = torch.as_tensor(
            logits_fn(state, {k: batch[k] for k in STEP_KEYS}))
        # reference uses floor division for decode lengths
        # (trainer_sr.py:110), unlike the ceil used in the loss
        dec_lens = np.asarray(batch["inp_len"]) // in_len_div
        dec_lens = np.minimum(np.maximum(dec_lens, 1), logits.shape[1])
        if decode_impl == "greedy":
            from srf_tpu_torch.ops.ctc_decode import greedy_decode

            with torch.inference_mode():
                ids, lens = greedy_decode(
                    logits, torch.as_tensor(dec_lens, device=logits.device))
            ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
            hyps = [list(ids[i, : lens[i]]) for i in range(ids.shape[0])]
        elif decode_impl == "device":
            from srf_tpu_torch.ops.ctc_beam import (
                ctc_beam_search_batch, lm_on_device)

            if device_lm is None:
                device_lm = lm_on_device(lm, logits.device)
            hyps = [
                ids for ids, _ in ctc_beam_search_batch(
                    logits, dec_lens, beam_width, lm=device_lm
                )
            ]
        else:
            hyps = beam_search_batch(logits.cpu().numpy(), dec_lens,
                                     beam_width, lm=lm)
        for i, utt_id in enumerate(batch.get("utt_ids", [])):
            values = " ".join(str(int(x)) for x in hyps[i])
            n = len(hyps[i])
            print('UTTID: ["%s"]' % utt_id, flush=True)
            # two lines shaped like tf.print's SparseTensor dump; the line
            # containing "values" has exactly one '[' before the values list
            # so the reference scraper's line.split("[")[2] lands on it
            # (reference: log2utt.py:86-88)
            print("SparseTensor(indices=[[0 0]", flush=True)
            print(
                " [0 %d]], values=[%s], shape=[1 %d])" % (max(n - 1, 0), values, n),
                flush=True,
            )
    logger.info("%.3f secs elapsed", time.time() - prev)
