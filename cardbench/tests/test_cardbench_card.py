"""Each cell's small world on the card: the hand-written kernels (one
constellation and the lane form) against the plain reference, through the
whole harness. Needs a CUDA card; run on the card with

    python -m pytest cardbench/tests/test_cardbench_card.py -m cuda -q
"""

import time

import pytest
import torch

from cardbench import harness
from cardbench.tests._tiny import full_manifest, tiny_config, tiny_traffic


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ffd64.deep", "fifo4k.chunked",
                                  "ffd64.seeds4"])
def test_cell_on_card_equals_reference(card, cell):
    manifest = full_manifest()
    spec = harness.find_cell(manifest, cell)
    out = harness.run_cell(cell, 2**31 + 99, 0.5, True, card,
                           time.perf_counter(), manifest,
                           config=tiny_config(spec["config"]),
                           traffic=tiny_traffic(spec["traffic"]))
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["busy_s"] > 0
