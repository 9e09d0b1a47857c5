"""Batch preparation for attention-style models (port of
``srf_tpu/train/prep.py``).

``prep_process`` (reference: tfsr/helper/train_helper.py:382-401) builds
the encoder padding bias and, for labeled batches, the shifted decoder
inputs and targets (``@ a b c`` / ``a b c $``) and the combined
look-ahead and padding mask. Inputs keep their padded shape (no crop to the
batch's longest; the masks carry the lengths).
"""

from srf_tpu_torch.ops.masking import create_combined_mask, get_padding_bias


def prep_process(labels, feat_len, tar_len, feats, in_len_div):
    """-> (feats, enc_pad_mask) without labels, else (feats, tar_inp,
    tar_real, enc_pad_mask, comb_mask). ``tar_len`` is unused (the
    reference cropped labels to it; the combined mask follows token 0
    padding instead)."""
    del tar_len
    enc_pad_mask = get_padding_bias(
        feat_len, -(-feats.shape[1] // in_len_div), in_len_div
    )
    if labels is None:
        return feats, enc_pad_mask
    tar_inp = labels[:, :-1]
    tar_real = labels[:, 1:]
    return feats, tar_inp, tar_real, enc_pad_mask, create_combined_mask(tar_inp)
