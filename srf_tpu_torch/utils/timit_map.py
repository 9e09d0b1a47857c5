"""TIMIT 61 -> 39 phone mapping (Lee & Hon 1989).

The port's copy of srf_tpu/utils/timit_map.py (reference:
tfsr/utils/log2utt.py:4-65). 'q' maps to the empty string
(deleted); closures/pauses collapse to 'sil'.
"""

PHONE_MAP = {
    "aa": "aa", "ae": "ae", "ah": "ah", "ao": "aa", "aw": "aw", "ax": "ah",
    "ax-h": "ah", "axr": "er", "ay": "ay", "b": "b", "bcl": "sil", "ch": "ch",
    "d": "d", "dcl": "sil", "dh": "dh", "dx": "dx", "eh": "eh", "el": "l",
    "em": "m", "en": "n", "eng": "ng", "epi": "sil", "er": "er", "ey": "ey",
    "f": "f", "g": "g", "gcl": "sil", "h#": "sil", "hh": "hh", "hv": "hh",
    "ih": "ih", "ix": "ih", "iy": "iy", "jh": "jh", "k": "k", "kcl": "sil",
    "l": "l", "m": "m", "n": "n", "ng": "ng", "nx": "n", "ow": "ow",
    "oy": "oy", "p": "p", "pau": "sil", "pcl": "sil", "q": "", "r": "r",
    "s": "s", "sh": "sh", "t": "t", "tcl": "sil", "th": "th", "uh": "uh",
    "uw": "uw", "ux": "uw", "v": "v", "w": "w", "y": "y", "z": "z",
    "zh": "sh",
}


def map_phones(phones):
    """Map 61-phone tokens to the 39 set, dropping deleted ones."""
    out = []
    for ph in phones:
        mapped = PHONE_MAP.get(ph, ph)
        if mapped:
            out.append(mapped)
    return out
