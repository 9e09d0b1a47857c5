"""Training / validation / decoding loops (port of ``srf_tpu/train/loop.py``).

Epoch loop with the reference's observable behavior
(reference: tfsr/trainer_sr.py:250-299):

- per-epoch train + valid passes, ``STEP`` progress prints every 50 steps,
- early stopping: "better" means the valid loss did not worsen by more than
  1% of the previous loss; a tolerance counter of consecutive non-better
  epochs triggers the stop (reference: trainer_sr.py:269-279),
- per-epoch checkpoint save gated by ``--train-ckpt-saving-per``,
- mid-epoch checkpoints (``--tpu-ckpt-every-steps``), SIGTERM handling, the
  watchdog and fault injection, as the JAX loop has them,
- decode mode (``--train-max-epoch=0``): CTC beam search over the test
  split, emitting ``UTTID: ["<id>"]`` + a sparse-values line compatible with
  the reference's log2utt scrapers (reference: trainer_sr.py:96-117,
  log2utt.py:78-93).

The state (a ``TrainState``) is updated in place by the steps. The
metrics stay device tensors; the loop reads them in one batch every 50
steps and at the end of an epoch, as JAX does, so the host never waits
for the card inside a run of steps.

Multi-process (a ``torch.distributed`` world of more than one rank, one
process per card), as JAX's loop runs on several processes:

- the steps return metrics already reduced over the data group
  (``train/step.py``), so every rank logs JAX's global numbers and
  early stopping decides the same epoch everywhere;
- only rank 0 writes checkpoints and ``metrics.jsonl``; every rank builds
  the checkpoint dict (an FSDP state gathers its shards), and a barrier
  over the host group follows each save;
- a SIGTERM is acted on only at consensus points (mid-checkpoint
  boundaries, the end of validation, the epoch save), where the ranks'
  flags are all-reduced (MAX) over the host group: all ranks save the
  same mid checkpoint and exit 143, or none does
  (``--tpu-fault-signal-process`` signals one rank);
- the mid-checkpoint signature folds in the process count.
"""

import itertools
import os
import signal
import time

import numpy as np
import torch

from srf_tpu_torch.ops.ctc_decode import beam_search_batch
from srf_tpu_torch.parallel import distributed
from srf_tpu_torch.utils.metrics import MeanMetric, MetricsWriter, SumMetric
from srf_tpu_torch.utils.profiler import span, trace as profiler_trace

STEP_KEYS = ("feats", "labels", "inp_len", "tar_len")
# the loader's host arrays that go to the device; the lengths stay on the
# host, where the CTC loss reads them (ops/ctc.py)
DEVICE_KEYS = ("feats", "labels")
# the loop position and accumulators a mid-epoch checkpoint saves
RESUME_KEYS = ("epoch", "batch_index", "train_loss_total",
               "train_loss_count", "num_feats_total", "num_feats_count",
               "train_samples", "pre_loss", "tolerance", "batch_sig")


def device_prefetch(iterator, device):
    """Yield the host batches of ``iterator`` with ``feats`` and ``labels``
    on ``device`` and the lengths as CPU tensors (the CTC loss reads them
    on the host). The loader's own producer thread (``BucketedLoader``'s
    ``prefetch``) builds batches ahead; this runs on the consumer thread,
    so every device call stays on one thread. On a CUDA device ``feats``
    and ``labels`` go through pinned memory with ``non_blocking=True``;
    each batch's pinned buffers stay referenced until an event recorded
    after their copies has completed.

    Each batch's production is a ``srf.feed`` span (``utils/profiler.py``)
    with two children: ``srf.feed.load``, the wait for the loader's next
    batch, and ``srf.feed.put``, the pinning and the copies."""
    pinned = device.type == "cuda"
    inflight = []  # (event, pinned tensors) until their copies are done

    def put(batch):
        staged = {k: torch.from_numpy(np.asarray(batch[k]))
                  for k in STEP_KEYS}
        if not pinned:
            for k in DEVICE_KEYS:
                staged[k] = staged[k].to(device)
            return staged
        while inflight and inflight[0][0].query():
            inflight.pop(0)
        held = []
        for k in DEVICE_KEYS:
            host = staged[k].pin_memory()
            held.append(host)
            staged[k] = host.to(device, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        inflight.append((event, held))
        return staged

    try:
        while True:
            with span("srf.feed"):
                with span("srf.feed.load"):
                    batch = next(iterator, None)
                if batch is None:
                    return
                with span("srf.feed.put"):
                    staged = put(batch)
            yield staged
    finally:
        for event, _ in inflight:
            event.synchronize()


def _drain(pending, train_loss, train_samples, num_feats):
    """Read the pending steps' metrics in one device-to-host copy."""
    if pending:
        rows = torch.stack([
            torch.stack([m["loss_sum"], m["samples"], m["frames"]])
            for m in pending]).tolist()
        for loss_sum, samples, frames in rows:
            train_loss.update(loss_sum, samples)
            train_samples.update(samples)
            num_feats.update(frames)
    return []


def run_training(config, logger, state, train_step, valid_step, train_loader,
                 valid_loader, ckpt_manager, epoch_offset, seed,
                 train_num, schedule_fn=None, metrics_path=None,
                 state_to_save=None, state_from_tree=None):
    """Returns the final state (the same object, updated in place).

    ``train_step(state, batch, seed) -> (state, metrics)`` and
    ``valid_step(state, batch) -> metrics`` (``train/step.py``); batches
    reach them with ``feats`` and ``labels`` on the state's device and the
    lengths on the host. ``state_to_save(state)`` gives
    the checkpoint dict, ``state_from_tree(tree)`` loads one into the state.

    Preemption safety (``--tpu-ckpt-every-steps N``, no reference analog —
    the reference only checkpoints per epoch, trainer_sr.py:280-288): every
    N optimizer steps the full state plus the loop position (epoch, batch
    index within the epoch) and the metric/early-stop accumulators are
    saved under ``$path-ckpt/mid``. A restarted process resumes from the
    freshest of {last epoch checkpoint, last mid checkpoint}: the epoch's
    shuffle order is a pure function of (seed, epoch) via
    ``loader.set_epoch``, the per-step dropout generator is seeded from the
    restored ``state.step``, and the already-consumed batches are skipped
    — so on the CPU the resumed run replays the uninterrupted run
    bit-exactly (tests/test_torch_train_loop.py); on the card cuDNN's and
    the CTC loss's backward are not bitwise deterministic.

    ``ckpt_manager.wait()`` runs before it returns: an asynchronous save is
    on disk before decoding or averaging reads it.
    """
    device = state.device
    n_proc = distributed.world_size()
    lead = distributed.rank() == 0  # the rank that writes files
    writer = MetricsWriter(metrics_path if lead else None)
    train_loss = MeanMetric()
    valid_loss = MeanMetric()
    num_feats = MeanMetric()
    train_samples = SumMetric()

    profile_dir = getattr(config, "tpu_profile_dir", None)
    pre_loss = 1e9
    tolerance = 0

    # ---- mid-epoch (preemption-safe) checkpointing --------------------
    mid_every = int(getattr(config, "tpu_ckpt_every_steps", 0) or 0)
    fault_at = int(getattr(config, "tpu_fault_at_step", 0) or 0)
    mid_mgr = None
    resume_epoch, resume_index = -1, 0
    # batch-geometry signature: ``resume.batch_index`` counts BATCHES, so
    # it only names the same data position if the bucket batch sizes are
    # unchanged; a mid checkpoint written under other sizes is refused
    # (epoch restart), not half-trusted. The process count folds in where
    # the loader's schedule depends on it: the lockstep schedule is
    # stratified by process, so the same local sizes under another count
    # name other data positions. Batch sharding slices the one-process
    # schedule of the same global batches, so there a mid checkpoint
    # resumes under another process count (elastic resume, as JAX's on a
    # resized mesh)
    per_process = getattr(train_loader, "per_process_schedule", True)
    batch_sig = float(sum(
        (i + 1) * int(s) for i, s in enumerate(
            getattr(train_loader, "batch_sizes", None) or [])
    )) + 1e6 * (n_proc - 1) * per_process
    if mid_every > 0 and not (config.path_ckpt and state_to_save is not None):
        logger.warning(
            "--tpu-ckpt-every-steps=%d has nothing to save to (no "
            "--path-ckpt / state serializer); mid-epoch checkpointing "
            "is DISABLED for this run", mid_every,
        )
    if mid_every > 0 and config.path_ckpt and state_to_save is not None:
        from srf_tpu_torch.utils.checkpoint import CheckpointManager

        mid_mgr = CheckpointManager(
            os.path.join(config.path_ckpt, "mid"), max_to_keep=2,
            use_async=bool(getattr(config, "tpu_async_ckpt", False)),
        )

        def purge_mid():
            distributed.barrier()  # every rank has read it
            if lead:
                mid_mgr.purge()
            distributed.barrier()

        last_mid = mid_mgr.latest_step()
        if last_mid is not None:
            try:
                restored = mid_mgr.restore(last_mid)
                meta = {key: restored["resume"][key] for key in RESUME_KEYS}
            except Exception as exc:  # noqa: BLE001 — refused, not fatal
                # e.g. a truncated file or another resume schema: refuse it
                # rather than crash the restart (the supervisor treats a
                # traceback as fatal)
                logger.warning(
                    "Ignoring mid-epoch checkpoint %s/mid/%d (unreadable "
                    "with this release's resume schema: %s); deleting it",
                    config.path_ckpt, last_mid, exc,
                )
                purge_mid()
                meta = None
            if meta is None:
                pass
            elif float(meta["batch_sig"]) != batch_sig:
                logger.warning(
                    "Ignoring mid-epoch checkpoint %s/mid/%d: it was "
                    "written under a different batch geometry (signature "
                    "%.0f vs %.0f — other bucket batch sizes?); its batch "
                    "index does not name the same data position, so "
                    "resuming from the last epoch checkpoint instead",
                    config.path_ckpt, last_mid,
                    float(meta["batch_sig"]), batch_sig,
                )
                # delete it: the restarted run's step restarts BELOW this
                # one, and a later resume must not pick the refused one
                purge_mid()
            elif int(meta["epoch"]) >= epoch_offset:
                if state_from_tree is None:
                    raise ValueError(
                        "mid-epoch checkpoint found but no state_from_tree "
                        "to rebuild the train state"
                    )
                state = state_from_tree(restored["state"])
                resume_epoch = int(meta["epoch"])
                resume_index = int(meta["batch_index"])
                epoch_offset = resume_epoch
                train_loss.total = float(meta["train_loss_total"])
                train_loss.count = float(meta["train_loss_count"])
                num_feats.total = float(meta["num_feats_total"])
                num_feats.count = float(meta["num_feats_count"])
                train_samples.total = float(meta["train_samples"])
                pre_loss = float(meta["pre_loss"])
                tolerance = int(meta["tolerance"])
                logger.info(
                    "Resuming mid-epoch from %s/mid/%d: epoch %d, batch %d",
                    config.path_ckpt, last_mid, resume_epoch, resume_index,
                )
            else:
                logger.info(
                    "Ignoring stale mid-epoch checkpoint (epoch %d < "
                    "resume offset %d); deleting it",
                    int(meta["epoch"]), epoch_offset,
                )
                purge_mid()

    def save_mid(epoch, next_index):
        tree = {
            "state": state_to_save(state),
            "resume": {
                "epoch": epoch, "batch_index": next_index,
                "train_loss_total": train_loss.total,
                "train_loss_count": train_loss.count,
                "num_feats_total": num_feats.total,
                "num_feats_count": num_feats.count,
                "train_samples": train_samples.total,
                "pre_loss": pre_loss, "tolerance": tolerance,
                "batch_sig": batch_sig,
            },
        }
        if lead:
            mid_mgr.save(state.step, tree)
        distributed.barrier()

    # ---- failure detection -------------------------------------------
    # SIGTERM = the cloud preemption notice: flag it, save a mid
    # checkpoint at the next progress point, exit 143 (the supervisor
    # restarts and resumes). Installed only when mid-epoch checkpointing
    # gives the handler somewhere to save.
    hang_at = int(getattr(config, "tpu_fault_hang_at_step", 0) or 0)
    sig_at = int(getattr(config, "tpu_fault_signal_at_step", 0) or 0)
    check_step = fault_at > 0 or hang_at > 0 or sig_at > 0
    sigterm_seen = {"flag": False}
    sig_installed = False
    if mid_mgr is not None:
        def _on_sigterm(signum, frame):
            sigterm_seen["flag"] = True

        try:
            _prev_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
            sig_installed = True
        except ValueError:  # not the main thread
            pass

    def preemption_agreed():
        """Multi-process: any rank's SIGTERM flag, all-reduced (MAX) over
        the host group. Called only at points every rank reaches in the
        same order, so all act together or none does."""
        return bool(distributed.host_all_reduce(
            [1.0 if sigterm_seen["flag"] else 0.0], op="max")[0])

    def handle_sigterm_if_seen(epoch, index, consensus=False):
        """Act on a pending preemption notice: save a mid checkpoint at
        the current loop position and exit 143. One process: at every
        progress point — train steps, validation batches, epoch boundary
        — so the grace window is never burned waiting for the next train
        step. Multi-process: only at consensus points (``consensus``), so
        the response waits at most --tpu-ckpt-every-steps steps and every
        rank saves the same checkpoint."""
        if n_proc > 1:
            if not consensus or mid_mgr is None or not preemption_agreed():
                return
        elif not sigterm_seen["flag"]:
            return
        if mid_mgr is not None:
            save_mid(epoch, index)
            mid_mgr.wait()
            logger.warning(
                "SIGTERM: saved mid-epoch checkpoint at global step "
                "%d (epoch %d, batch %d); exiting 143 — restart "
                "resumes exactly", state.step, epoch, index,
            )
        else:  # pragma: no cover — handler only installed with mid_mgr
            logger.warning("SIGTERM: no mid-epoch checkpointing; "
                           "exiting 143")
        os._exit(143)

    # Watchdog (hang -> crash -> restart -> resume): armed lazily after
    # the FIRST optimizer step completes, so the first step's kernel
    # builds and cuDNN searches never trip it.
    watchdog_secs = float(getattr(config, "tpu_watchdog_secs", 0) or 0)
    watchdog = None

    def kick_watchdog():
        nonlocal watchdog
        if watchdog_secs <= 0:
            return
        if watchdog is None:
            from srf_tpu_torch.utils.watchdog import Watchdog

            watchdog = Watchdog(watchdog_secs, logger=logger).start()
        watchdog.kick()

    def teardown():
        if watchdog is not None:
            watchdog.stop()
        if sig_installed:
            signal.signal(signal.SIGTERM, _prev_sigterm)

    try:
        for epoch in range(epoch_offset, config.train_max_epoch):
            if hasattr(train_loader, "set_epoch"):
                train_loader.set_epoch(epoch)
            resuming = epoch == resume_epoch and resume_index > 0
            if not resuming:
                train_loss.reset()
                num_feats.reset()
                train_samples.reset()
            valid_loss.reset()

            prev = time.time()
            index = 0
            pending = []  # device metrics, read lazily so steps pipeline
            tracing = bool(profile_dir) and epoch == epoch_offset
            if tracing:
                # profile the first trained epoch (a Chrome trace)
                trace_cm = profiler_trace(profile_dir)
                trace_path = trace_cm.__enter__()
                logger.info("Profiler trace -> %s", trace_path)
            batches = iter(train_loader)
            if resuming:
                batches = itertools.islice(batches, resume_index, None)
                index = resume_index
            for batch in device_prefetch(batches, device):
                state, metrics = train_step(state, batch, seed)
                pending.append(metrics)
                index += 1
                kick_watchdog()
                if mid_mgr is not None and index % mid_every == 0:
                    pending = _drain(pending, train_loss, train_samples,
                                     num_feats)
                    # a consensus point: if any rank holds a preemption
                    # notice, all save this mid checkpoint and exit 143
                    handle_sigterm_if_seen(epoch, index, consensus=True)
                    save_mid(epoch, index)
                if check_step:
                    # exact-equality triggers: a supervised restart resumes
                    # PAST the fault step, so the injection fires once per
                    # job, not once per restart
                    gstep = state.step
                    if fault_at > 0 and gstep == fault_at:
                        if mid_mgr is not None:
                            mid_mgr.wait()
                        logger.warning(
                            "FAULT INJECTION: hard-exit at global step %d "
                            "(--tpu-fault-at-step)", fault_at,
                        )
                        os._exit(42)
                    if hang_at > 0 and gstep == hang_at:
                        logger.warning(
                            "FAULT INJECTION: hanging the host loop at global "
                            "step %d (--tpu-fault-hang-at-step)", hang_at,
                        )
                        while True:
                            time.sleep(60)
                    sig_proc = int(getattr(
                        config, "tpu_fault_signal_process", -1) or -1)
                    if (sig_at > 0 and gstep == sig_at
                            and sig_proc in (-1, distributed.rank())):
                        logger.warning(
                            "FAULT INJECTION: raising SIGTERM to self at "
                            "global step %d (--tpu-fault-signal-at-step)",
                            sig_at,
                        )
                        sig_at = 0  # once
                        os.kill(os.getpid(), signal.SIGTERM)
                if sigterm_seen["flag"]:
                    pending = _drain(pending, train_loss, train_samples,
                                     num_feats)
                    handle_sigterm_if_seen(epoch, index)
                if (index - 1) % 50 == 0 and (index - 1) > 0:
                    pending = _drain(pending, train_loss, train_samples,
                                     num_feats)
                    step_i = state.step
                    lr = float(schedule_fn(step_i)) if schedule_fn else float(
                        config.train_lr_param_k or 0.0
                    )
                    print(
                        "STEP %d %.6f %.6f %.8f"
                        % (
                            step_i,
                            train_samples.result() / max(train_num, 1) * 100.0,
                            train_loss.result(),
                            lr,
                        ),
                        flush=True,
                    )
            _drain(pending, train_loss, train_samples, num_feats)
            if index == 0:
                # every bucket starved (corpus smaller than the bucket
                # batch sizes): an epoch that trains nothing must be loud,
                # not a 0.0000-loss line
                logger.warning(
                    "Train epoch %03d yielded NO batches — corpus too "
                    "small for the bucket batch sizes (every bucket batch "
                    "needs %s examples)?",
                    epoch + 1, getattr(train_loader, "batch_sizes", "?"),
                )
            if tracing:
                trace_cm.__exit__(None, None, None)
            train_secs = time.time() - prev
            step_i = state.step
            logger.info(
                "Epoch %03d Train Loss %.4f, %.3f secs, %d feats/step, %d/%d steps",
                epoch + 1, train_loss.result(), train_secs,
                int(num_feats.result()), step_i, config.train_max_step,
            )
            writer.write(
                {"kind": "train_epoch", "epoch": epoch + 1,
                 "loss": train_loss.result(), "secs": train_secs, "step": step_i,
                 "samples": train_samples.result()}
            )

            prev = time.time()
            pending = []
            for batch in device_prefetch(iter(valid_loader), device):
                pending.append(valid_step(state, batch))
                kick_watchdog()
                handle_sigterm_if_seen(epoch, index)
            # read INCREMENTALLY: each read waits only for its batch, so
            # the watchdog sees progress per batch, and a preemption notice
            # is acted on between batches
            for metrics in pending:
                loss_sum, samples = torch.stack(
                    [metrics["loss_sum"], metrics["samples"]]).tolist()
                valid_loss.update(loss_sum, samples)
                kick_watchdog()
                handle_sigterm_if_seen(epoch, index)
            # the end of validation: a consensus point
            handle_sigterm_if_seen(epoch, index, consensus=True)
            valid_secs = time.time() - prev
            if valid_loss.count == 0:
                # every bucket's remainder was dropped (valid set smaller than
                # the smallest bucket batch — reference drop_remainder=True,
                # load_speech_data.py:174): a 0.0000 valid loss would silently
                # disable early stopping, so say it out loud
                logger.warning(
                    "Validation yielded NO batches (valid set smaller than the "
                    "bucket batch sizes?); early stopping is inert this epoch")
            better = valid_loss.result() - pre_loss <= (pre_loss * 0.01)
            tolerance = 0 if better else tolerance + 1
            logger.info(
                "Epoch %03d Valid Loss %.4f, %.3f secs%s",
                epoch + 1, valid_loss.result(), valid_secs,
                ", improved" if better else ", tolerance %d" % tolerance,
            )
            writer.write(
                {"kind": "valid_epoch", "epoch": epoch + 1,
                 "loss": valid_loss.result(), "secs": valid_secs,
                 "better": bool(better), "tolerance": tolerance}
            )
            pre_loss = valid_loss.result()

            # early stop BEFORE saving: the regressed final epoch gets no
            # checkpoint, so checkpoint averaging sees the same last-N set as
            # the reference (reference: tfsr/trainer_sr.py:277-288)
            if 0 < config.train_es_tolerance <= tolerance:
                logger.info("early stopped!")
                break
            if config.train_ckpt_saving_per > 0:
                to_save = state_to_save(state) if state_to_save else state
                if lead:
                    path = ckpt_manager.save(epoch + 1, to_save)
                    logger.info("Saving a ckpt for the last epoch at %s",
                                path)
                distributed.barrier()
                kick_watchdog()
                # a notice during valid/save: the mid written here is
                # older than the epoch ckpt just saved, so the restart
                # ignores it (stale) and resumes at epoch+1 cleanly (a
                # consensus point)
                handle_sigterm_if_seen(epoch, index, consensus=True)
            else:
                logger.warning(
                    "Not saved since train-ckpt-saving-per is %d, it needs to be "
                    "bigger than 0 if you want save checkpoints",
                    config.train_ckpt_saving_per,
                )

    finally:
        teardown()
        writer.close()
    if mid_mgr is not None:
        mid_mgr.close()
    if hasattr(ckpt_manager, "wait"):
        ckpt_manager.wait()  # asynchronous saves on disk before decoding
    return state


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
