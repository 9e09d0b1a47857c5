"""Vocabulary loading (the port's copy of ``srf_tpu/utils/vocab.py``).

Reference parity: tfsr/helper/misc_helper.py:62-108. CTC blank handling
matches the trainers: the blank class is *appended* after the vocabulary,
``dec_out_dim = dec_in_dim + 1`` and ``blank_idx = dec_in_dim``.
"""

import os
import sys

from srf_tpu_torch.config.constants import Constants, ExitCode


def load_vocab(vocab_path, logger=None):
    """Load a vocab file (one token per line).

    Returns (vocab_list, str_to_int, dec_in_dim, dec_out_dim). ``<SPACE>``
    becomes a literal space in the list. Logs critical if the last token is
    not BOS ``@`` (the reference only warns; it does not exit).
    """
    vocab = []
    with open(vocab_path) as vocab_file:
        for line in vocab_file:
            token = line.strip()
            vocab.append(" " if token == Constants.SPACE else token)

    if vocab and vocab[-1] != Constants.BOS:
        msg = "Last index must be BOS: %s, but %s" % (Constants.BOS, vocab[-1])
        if logger is None:
            print(msg)
        else:
            logger.critical(msg)

    str_to_int = {token: token_id for token_id, token in enumerate(vocab)}
    dec_in_dim = len(vocab)
    dec_out_dim = dec_in_dim - 1 if Constants.BOS in str_to_int else dec_in_dim

    msg = "Decoder Input Dim: %d, Output Dim %d" % (dec_in_dim, dec_out_dim)
    if logger is None:
        print(msg)
    else:
        logger.info(msg)

    return vocab, str_to_int, dec_in_dim, dec_out_dim


def get_int_seq(text, is_char, vocab):
    """Convert text to integer ids (char mode or BPE/space-split mode)."""
    int_seq = []
    text = text.strip().replace("  ", " ")
    if is_char:
        for char in text:
            if char in vocab:
                int_seq.append(vocab[char])
            elif char == " ":
                int_seq.append(vocab[Constants.SPACE])
            else:
                print(vocab)
                print("%s is not in vocab" % char)
                sys.exit(ExitCode.NOT_SUPPORTED.value)
    else:
        for bpe in text.split(" "):
            int_seq.append(vocab[bpe])
    return int_seq


def get_file_path(data_path, file_path):
    """Resolve a path against a base dir (reference: misc_helper.py:62-75)."""
    data_path = data_path.strip()
    file_path = file_path.strip()
    return file_path if os.path.isfile(file_path) else data_path + "/" + file_path
