"""The harness on the card at a tiny size: the timed path, the device
trace and every per-layer reader.  Skips without a card."""

from __future__ import annotations

import time

import pytest

from benchmark import run, spec


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_cell_on_the_card(card, tiny_root, trace):
    cell = spec.Cell("binmean_qc.run8k", tiny_root)
    res = run.Run(cell, 2**31 + 3, 1.0, trace,
                  t_start=time.perf_counter()).execute()
    assert res["correct"] is True
    assert res["device"]["kind"] == card
    assert res["device"]["platform"] == "gpu"
    if trace:
        assert 0 < res["device"]["busy_s"] < res["device"]["window_s"]
        assert 0 < res["metrics"]["device_roofline"]["value"] < 100
        assert len(res["breakdown"]["device_ops"]) <= 10
