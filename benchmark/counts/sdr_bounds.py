"""The least time the card could take for one call of the SDR kernels K1
(forward) and K2 (backward), from the call's shapes alone.

A bound is the larger of the call's bytes over the HBM bandwidth and its
float32 operations over the float32 peak (``flops.H100_HBM_BPS``,
``flops.H100_PEAK_FP32``: the published SXM5 H100 rates at 700 W). Each
input byte is counted as read once and each output byte as written once,
whatever the kernels read again. The counts are of the work the call's
arithmetic needs, not of how a kernel does it: K2's count leaves out the
forward step that the port's K2 recomputes (its prediction and routing), so
it reads the same for any implementation of the backward.

``geometry`` is a routing layer's ``(in_n, out_n, out_d, in_d)``; ``batch``
and ``seq_len`` are the call's rows and (subsampled) steps, padding
included: the kernels route every padded step.
"""

from benchmark.counts.flops import H100_HBM_BPS, H100_PEAK_FP32


def k1_counts(batch, seq_len, geometry, num_iter):
    """(bytes, float32 operations) of one SDR forward call: the prediction
    ``u_hat = W u + b`` and ``num_iter`` routing iterations a step."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    nbytes = 4 * (batch * seq_len * in_n * in_d + in_n * out_no * in_d
                  + in_n * out_no + batch * seq_len * out_no)
    per_step = 2 * in_d * in_n * out_no + num_iter * (
        4 * in_n * out_no      # agreement and s contractions
        + 6 * in_n * out_n     # logit update and softmax
        + 4 * out_no + 4 * out_n)  # squash
    return nbytes, batch * seq_len * per_step


def k2_counts(batch, seq_len, geometry):
    """(bytes, float32 operations) of one SDR backward call (one routing
    iteration): u, W, bias, the outputs and their cotangents read once; du,
    dW, db written once; the backward's own arithmetic only."""
    in_n, out_n, out_d, in_d = geometry
    out_no = out_n * out_d
    u_size, w_size = batch * seq_len * in_n * in_d, in_n * out_no * in_d
    v_size, b_size = batch * seq_len * out_no, in_n * out_no
    nbytes = 4 * 2 * (u_size + w_size + b_size + v_size)
    per_step = (4 * in_d * in_n * out_no   # dW and du contractions
                + 8 * in_n * out_no        # dc, carry, du_hat, db
                + 4 * in_n * out_n         # softmax backward
                + 4 * out_no + 12 * out_n)  # squash backward
    return nbytes, batch * seq_len * per_step


def bound_s(counts):
    """Seconds the card needs at least for (bytes, operations), and which
    of the two bounds it: ``(seconds, "bytes" | "operations")``."""
    nbytes, flops = counts
    by_bytes, by_ops = nbytes / H100_HBM_BPS, flops / H100_PEAK_FP32
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")
