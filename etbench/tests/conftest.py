"""Tests of the benchmark: CPU tests at small sizes; tests marked `cuda` need
the card and skip where there is none (decided inside the `cuda` fixture,
never at import).

    python -m pytest etbench/tests -q            # here
    python -m pytest etbench/tests -q -m cuda    # on the card
"""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Small traffic for the CPU: the cells' own mixes at a size a test run holds.
SMALL = {
    "agentformer-zara2.serve": {"pool": {"scenes": 6, "min_peds": 2, "max_peds": 6, "counts_seed": 0},
                                "scenes_per_request": [1, 4], "rate_per_s": 10.0,
                                "checked_requests": 3},
    "stgcnn-hotel.eval": {"split": {"scenes": 6, "min_peds": 2, "max_peds": 5, "counts_seed": 0},
                          "n_max_peds": 8, "eval_batch": 8, "checked_calls": 3},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips where there is none)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def bench():
    from etbench.run import load_json

    return load_json("BENCHMARK.json")


@pytest.fixture(scope="session")
def cells(bench):
    return {w["name"]: w for w in bench["workloads"]}
