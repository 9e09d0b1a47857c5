"""A run with the timed path broken underneath comes out not correct: once
for each fault its cell can have (the harness's look for a card skipped,
the rest of the run as it is, at a tiny size on the CPU)."""

import pytest

from benchmark import run
from benchmark.tests import tiny

CASES = [("srf_wsj.train", "frozen_state"), ("srf_wsj.train", "half_batch"),
         ("srf_wsj.train", "short_update"),
         ("srf_timit.train", "frozen_state"),
         ("srf_timit.train", "half_batch"),
         ("srf_timit.train", "short_update"),
         ("srf_wsj.serve", "altered_token")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(tiny_root, cell, fault):
    line, checks = run.run(tiny.context(tiny_root, cell, faults=[fault]))
    assert not line["correct"], checks
    if fault == "short_update":
        # the median leaf's change is the number that sees it
        assert checks["change_median"]["value"] > \
            checks["change_median"]["limit"], checks
