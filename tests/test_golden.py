"""Golden-histogram regression tests (BASELINE configs #1-#3).

The analog of the reference's frozen-RNG PPC comparison
(resources/scripts/compareToPPCredux/, SURVEY.md section 4.3): pinned-seed
workloads whose per-DOM hit-time histograms must stay within 0.1% L1 of the
committed goldens.  Regenerate with scripts/make_golden.py only for
deliberate physics changes."""

import os

import numpy as np
import pytest

from clsim_tpu.util.golden import CONFIGS, compare_to_golden, run_config

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_matches_golden(name):
    path = os.path.join(GOLDEN_DIR, name + ".npz")
    if not os.path.exists(path):
        pytest.skip("golden missing; run scripts/make_golden.py")
    golden = dict(np.load(path))
    result = run_config(name)
    # sanity: the workloads are non-trivial
    assert float(golden["n_hits"]) > 25
    compare_to_golden(result, golden)
