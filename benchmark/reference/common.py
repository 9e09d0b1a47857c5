"""What every family's reference shares, in plain PyTorch: the dropout
stream, the CTC loss, the Adam/Noam update, greedy CTC, the served-symbol
gaps and the TF32 switch.

Like the families' modules beside it, this imports nothing of the program
(neither ``srf_tpu_torch`` nor the JAX package).

Dropout (training only): an element is kept where a uniform draw is at
least the rate, and scaled by 1 / (1 - rate). A configuration states where
the draws come from, so that a run is reproducible: a generator on the
batch's device seeded with :func:`dropout_seed` of the run's seed and the
update count, drawing one uniform tensor of the activation's shape at each
dropout site in the order the family's ``forward`` names them.
:class:`Dropout` draws them so.
"""

import torch
import torch.nn.functional as F


def dropout_seed(seed, step):
    """The seed of update ``step``'s dropout generator under the run's
    ``seed``."""
    return (seed * 1_000_003 + step) % (1 << 63)


class Dropout:
    """Draws the masks of one update from ``generator``; without one it is
    the identity (eval)."""

    def __init__(self, generator=None):
        self.generator = generator

    def __call__(self, x, rate):
        if self.generator is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device,
                          dtype=x.dtype) >= rate
        return x * keep / (1.0 - rate)


def ctc_losses(logits, lengths, labels, label_lengths, subsample, blank):
    """Per-utterance CTC negative log-likelihood over
    ``min(ceil(len / subsample), T')`` logit frames."""
    frames = torch.clamp(torch.ceil(torch.as_tensor(lengths).float()
                                    / subsample).long(),
                         max=logits.shape[1])
    logp = torch.log_softmax(logits, dim=-1).transpose(0, 1)
    return F.ctc_loss(logp, labels.long(), frames,
                      torch.as_tensor(label_lengths).long(),
                      blank=blank, reduction="none")


def noam(opt, count):
    """The Noam rate at ``count`` updates made: ``k d^-0.5 min(count^-0.5,
    count warmup^-1.5)``, capped at ``lr_max``."""
    count = max(float(count), 1e-9)
    rate = opt["noam_k"] * float(opt["d_model"]) ** -0.5 * min(
        count ** -0.5, count * opt["warmup"] ** -1.5)
    return min(rate, opt["lr_max"])


class Adam:
    """Adam with bias-corrected moments and eps outside the square root,
    the rate read from the Noam schedule at the count of updates made."""

    def __init__(self, params, opt, count):
        self.params, self.opt, self.count = params, opt, count
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads):
        b1, b2, eps = self.opt["beta1"], self.opt["beta2"], self.opt["eps"]
        rate = noam(self.opt, self.count)
        self.t += 1
        for k, p in self.params.items():
            self.m[k].mul_(b1).add_(grads[k], alpha=1 - b1)
            self.v[k].mul_(b2).addcmul_(grads[k], grads[k], value=1 - b2)
            m_hat = self.m[k] / (1 - b1 ** self.t)
            v_hat = self.v[k] / (1 - b2 ** self.t)
            p.sub_(rate * m_hat / (torch.sqrt(v_hat) + eps))
        self.count += 1


def greedy(logits, frames, blank):
    """Greedy CTC of [T', K] logits over ``frames`` frames: (ids, the frame
    each id's run starts)."""
    best = logits[:frames].argmax(-1).tolist()
    ids, starts, prev = [], [], None
    for t, k in enumerate(best):
        if k != prev and k != blank:
            ids.append(k)
            starts.append(t)
        prev = k
    return ids, starts


def served_gaps(logits, ids, starts, frames, blank):
    """[frames] gaps by which the served symbol of each frame lies below
    the best logit of ``logits`` [T', K]: at a served id's first frame that
    id; at any other frame the better of the blank and the id whose run it
    may continue (greedy CTC emits nothing there)."""
    logits = torch.as_tensor(logits)[:frames].double()
    best = logits.max(-1).values
    served = logits[:, blank].clone()
    starts = list(starts)
    for j, t in enumerate(starts):
        if t >= frames:
            raise ValueError("served id at frame %d past %d" % (t, frames))
        end = starts[j + 1] if j + 1 < len(starts) else frames
        served[t] = logits[t, ids[j]]
        served[t + 1:end] = torch.maximum(logits[t + 1:end, blank],
                                          logits[t + 1:end, ids[j]])
    return (best - served).numpy()


def tf32(enabled):
    """Set TF32 for float32 matmuls and convolutions (the reference runs
    with it off; the control with it on)."""
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
