"""The SDR variants tool's source edits, on the CPU (the variant kernels
build and run only on the card): each variant edits one file of the
sources as they stand, in one place, and an edit whose text is missing
raises."""

import os

import pytest

from srf_tpu_torch.ops import cuda_build
from srf_tpu_torch.tools import sdr_variants as tool


def _sources():
    sources = {}
    for file_name in ("sdr_fwd.cu", "sdr_bwd.cu", "sdr_stream.cuh"):
        with open(os.path.join(cuda_build.CSRC, file_name)) as src:
            sources[file_name] = src.read()
    return sources


@pytest.mark.parametrize("edits,gone", [
    (tool.SOFTMAX_WITH_MAX, "kSafeLogit = 64.f"),
    (tool.UHAT_KEPT, "launch_predict("),
], ids=["max_always", "uhat_kept"])
def test_each_variant_edits_one_place_of_one_file(edits, gone):
    sources = _sources()
    out = tool.variant_source(sources, edits)
    (file_name, _, replacement), = edits
    assert [f for f in sources if out[f] != sources[f]] == [file_name]
    assert out[file_name].count(replacement) == 1
    assert gone in sources[file_name] and gone not in out[file_name]


def test_an_edit_whose_text_is_missing_raises():
    with pytest.raises(ValueError, match="occurs 0 times"):
        tool.variant_source(_sources(),
                            (("sdr_fwd.cu", "no such text", "x"),))
