"""Attention-map plotting (the port's own copy of
``srf_tpu/utils/plotting.py``; reference: tfsr/helper/misc_helper.py:
171-190).

Saves to a file instead of plt.show(), so it runs without a display.
``attention`` is [H, Q, K] or [B, H, Q, K] (the first utterance is drawn):
a numpy array, or a tensor such as the weights the port's
``models/layers.MultiHeadAttention`` returns on its plain path.
"""

import numpy as np


def plot_attention_weights(attention, out_path, title="attention map"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if hasattr(attention, "detach"):  # a torch tensor
        attention = attention.detach().float().cpu().numpy()
    attention = np.asarray(attention)
    if attention.ndim == 4:  # [B, H, Q, K] -> first batch element
        attention = attention[0]
    n_heads = attention.shape[0]
    cols = 2
    rows = -(-n_heads // cols)
    fig = plt.figure(figsize=(16, 8))
    plt.title(title)
    for head in range(n_heads):
        ax = fig.add_subplot(rows, cols, head + 1)
        ax.matshow(attention[head], cmap="viridis")
        ax.set_xlabel("head %d" % head)
    plt.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return out_path
