"""Global constants, dataset tags and typed exit codes.

Mirrors the observable surface of the reference config substrate
(reference: tfsr/helper/common_helper.py:33-95) so conf files, vocabs and
recipes written for the reference work unchanged against this framework.
"""

from enum import Enum


class Tag:
    """Dataset split tags."""

    TRAIN = "train"
    VALID = "valid"
    TEST = "test"


class Constants:
    """Special tokens and numeric constants."""

    # Special tokens
    PAD_CHAR = "p"
    PAD_WORD = "<PADDING_SYMBOL>"
    SPACE = "<SPACE>"
    UNK = "<unk>"
    UNKS = ("<UNK>", "<unk>")
    EOS = "$"
    BOS = "@"
    EPS = 1e-14
    NOISE_SYM = "n"
    INF = 1e9

    # Token unit
    WORD = "word"
    CHAR = "char"

    # Json manifest keys
    DURATION = "duration"
    KEY = "key"
    TEXT = "text"

    # Smoothing
    SM_NEIGHBOR = "neighbor"
    SM_LABEL = "label"

    # Initializer names
    INIT_GLOROT = "glorot_uniform"
    INIT_FANAVG = "fan_avg"
    INIT_UNIFORM = "uniform"


class ExitCode(Enum):
    """Typed CLI exit codes."""

    NO_DATA = 0
    NOT_SUPPORTED = 1
    INVALID_OPTION = 11
    INVALID_CONVERSION = 12
    INVALID_NAME = 13
    INVALID_NAME_OF_CONFIGURATION_FILE = 14
    INVALID_FILE_PATH = 15
    INVALID_DICTIONARY = 16
    INVALID_CONDITION = 17
