"""A run with the timed path broken underneath it comes out not correct,
once for each fault a cell of this system can have.  (Every cell runs
on one card, so there is no exchange between cards to leave out.)"""

from __future__ import annotations

import time

import pytest
import torch

from benchmark import run, spec
from specpride_tpu_torch import cli
from specpride_tpu_torch.ops import kernels

CELLS = ["binmean_qc.run8k", "gap.run8k"]


def unchanged(keys_or_head, *values):
    """The step hands its input back: each element its own 'mean'."""
    n = values[-1].numel()
    return (torch.ones(n, dtype=torch.float32, device=values[-1].device),
            *(v.to(torch.float32) for v in values))


def half_left_out_mean(keys, w, *values):
    """Every other element left out, the mean taken over the rest."""
    keep = (torch.arange(w.numel(), device=w.device) % 2 == 0)
    return kernels.seg_mean_plain(keys, w * keep.to(w.dtype), *values)


def half_left_out_heads(head, *values):
    keys = torch.cumsum((head != 0).to(torch.int32), 0).to(torch.int32)
    keep = (torch.arange(keys.numel(), device=keys.device) % 2 == 0)
    return kernels.seg_mean_plain(keys, keep.to(torch.float32),
                                  *(v.to(torch.float32) for v in values))


def altered_writer(real):
    """The first representative's first intensity altered by 1e-3, where
    the answer is written."""
    def write(spectra, path, append=False):
        spectra = list(spectra)
        if spectra and spectra[0].intensity.size:
            spectra[0].intensity = spectra[0].intensity.copy()
            spectra[0].intensity[0] *= 1.0 + 1e-3
        return real(spectra, path, append=append)
    return write


def broken_run(root: str, cell: str) -> dict:
    r = run.Run(spec.Cell(cell, root), 2**32 + 5, 0.3, False,
                device="cpu", t_start=time.perf_counter())
    return r.execute()


@pytest.mark.parametrize("cell", CELLS)
def test_a_step_that_returns_its_input_unchanged(tiny_root, monkeypatch,
                                                  cell):
    monkeypatch.setattr(kernels, "seg_mean", unchanged)
    monkeypatch.setattr(kernels, "seg_mean_heads", unchanged)
    assert broken_run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_half_the_batch_left_out(tiny_root, monkeypatch, cell):
    monkeypatch.setattr(kernels, "seg_mean", half_left_out_mean)
    monkeypatch.setattr(kernels, "seg_mean_heads", half_left_out_heads)
    assert broken_run(tiny_root, cell)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_an_answer_altered_where_it_is_written(tiny_root, monkeypatch,
                                               cell):
    monkeypatch.setattr(cli, "write_mgf", altered_writer(cli.write_mgf))
    res = broken_run(tiny_root, cell)
    assert res["correct"] is False
    assert res["check"]["peak_gap"]["value"] > \
        res["check"]["peak_gap"]["limit"]


def test_the_unbroken_run_is_correct(tiny_root):
    assert broken_run(tiny_root, "gap.run8k")["correct"] is True
