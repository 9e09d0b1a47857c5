"""Decoded ids -> text (the ``ids_to_utt`` part of ``srf_tpu/utils/log2utt.py``).

TIMIT: ids -> phones -> 61->39 mapping (reference: tfsr/utils/log2utt.py);
WSJ/char: ids -> chars, ``<SPACE>`` -> ' ' (reference: log2utt_wsj.py).
"""

from srf_tpu_torch.utils.timit_map import map_phones


def ids_to_utt(ids, vocab, corpus):
    if corpus == "timit":
        phones = [vocab[i] for i in ids]
        return " ".join(map_phones(phones))
    # wsj/char: join, <SPACE> -> ' '
    chars = []
    for i in ids:
        token = vocab[i]
        chars.append(" " if token == "<SPACE>" else token)
    return "".join(chars).strip()
