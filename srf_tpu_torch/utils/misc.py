"""Small utilities (the port's own copy of ``srf_tpu/utils/misc.py``;
reference: tfsr/helper/misc_helper.py Util statics and
tfsr/helper/train_helper.py:159-168 shuffle_data)."""

import os
import sys
import time

import numpy as np


def current_time_millis():
    return int(round(time.time() * 1000))


def make_dir(path):
    os.makedirs(path, exist_ok=True)


def get_file_line(fname):
    with open(fname) as f:
        return sum(1 for _ in f)


def all_exist(file_names):
    return all(os.path.exists(name) for name in file_names)


def shuffle_data(texts, seed=None):
    """Shuffle a list (reference: train_helper.py:159-168)."""
    rng = np.random.RandomState(seed)
    perm = rng.permutation(len(texts))
    return [texts[i] for i in perm]


def print_progress(iteration, total, prefix="", suffix="", decimals=1,
                   bar_len=100):
    """Console progress bar (reference: misc_helper.py:110-137)."""
    percent = ("{0:." + str(decimals) + "f}").format(
        100 * (iteration / float(total))
    )
    filled = int(round(bar_len * iteration / float(total)))
    bar = "#" * filled + "-" * (bar_len - filled)
    sys.stdout.write(
        "\r%s |%s| %s%% (%d/%d) %s" % (prefix, bar, percent, iteration, total,
                                       suffix)
    )
    if iteration == total:
        sys.stdout.write("\n")
    sys.stdout.flush()
