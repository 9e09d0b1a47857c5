"""Faults the tests plant in the program underneath a run, to see the
comparison that decides ``correct`` come out false. No run of the
benchmark's command plants any: only ``Context.faults`` asks for them.

- ``frozen_state``: the update leaves the weights as they were;
- ``half_batch``: the step sees the first half of its rows, and its loss is
  their mean;
- ``short_update``: every update moves the weights 0.9 of the way Adam
  says (the learning rate a tenth short);
- ``altered_token``: greedy decoding serves another id for each
  utterance's first symbol.
"""


def install(names):
    """Patch the program for each fault in ``names`` (in this process);
    returns a function that takes the patches out again."""
    saved = []
    for name in names:
        module, attr, patch = PLANT[name]()
        saved.append((module, attr, getattr(module, attr)))
        setattr(module, attr, patch)

    def undo():
        for module, attr, original in reversed(saved):
            setattr(module, attr, original)

    return undo


def _frozen_state():
    from srf_tpu_torch.train import step as step_mod

    def optimizer_update(state, ema_decay=0.0):
        if state.scheduler is not None:
            state.scheduler.step()
        state.step += 1

    return step_mod, "optimizer_update", optimizer_update


def _half_batch():
    from srf_tpu_torch.train import step as step_mod

    make = step_mod.make_train_step

    def make_train_step(*args, **kwargs):
        inner = make(*args, **kwargs)

        def train_step(state, batch, seed):
            half = batch["feats"].shape[0] // 2
            return inner(state, {k: v[:half] for k, v in batch.items()},
                         seed)

        return train_step

    return step_mod, "make_train_step", make_train_step


def _short_update():
    from srf_tpu_torch.train import step as step_mod

    update = step_mod.optimizer_update

    def optimizer_update(state, ema_decay=0.0):
        # the schedule's step sets the next rate anew from its base
        for group in state.optimizer.param_groups:
            group["lr"] *= 0.9
        update(state, ema_decay)

    return step_mod, "optimizer_update", optimizer_update


def _altered_token():
    from srf_tpu_torch import serve

    decode = serve.greedy_decode_frames

    def greedy_decode_frames(logits, lengths, blank_id):
        out, lens, emit = decode(logits, lengths, blank_id=blank_id)
        out = out.clone()
        out[:, 0] = (out[:, 0] + 1) % blank_id
        return out, lens, emit

    return serve, "greedy_decode_frames", greedy_decode_frames


PLANT = {"frozen_state": _frozen_state, "half_batch": _half_batch,
         "short_update": _short_update, "altered_token": _altered_token}
