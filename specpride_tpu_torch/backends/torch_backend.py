"""The port's device backend: binned-mean consensus on the flat layout.

``TorchBackend.run_bin_mean`` packs every kept peak flat on the host
(``data.packed.pack_flat_bin_mean``), computes per chunk on the host what
its sorted pass gives exactly (run counts, the integer quorum, the m/z
means), sends intensities and composite keys to the card, runs
``ops.binning.bin_mean_flat_intensity`` there and assembles the spectra
from the host m/z means and the card's intensity means.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from specpride_tpu_torch.config import BinMeanConfig
from specpride_tpu_torch.data.packed import _as_table, pack_flat_bin_mean
from specpride_tpu_torch.data.peaks import Cluster, Spectrum
from specpride_tpu_torch.ops import binning

PHASES = ("pack", "h2d", "kernel", "d2h", "finalize")


def check_no_empty(clusters: list[Cluster]) -> None:
    """Zero-member clusters are rejected up front, so no output can be
    misaligned against its input."""
    for c in clusters:
        if c.n_members == 0:
            raise ValueError(f"empty cluster {c.cluster_id!r}")


def check_uniform_charge(members: list[Spectrum]) -> None:
    """All precursor charges in a cluster must be equal (ref
    src/binning.py:206 assert, a ValueError here)."""
    charges = [s.precursor_charge for s in members]
    if any(z != charges[0] for z in charges):
        raise ValueError("Not all precursor charges in cluster are equal")


class TorchBackend:
    """Runs the consensus on ``device`` ("cuda" unless the caller asks for
    "cpu").  ``max_grid_elements // 4`` bounds the peaks of one chunk.

    ``phase_seconds`` accumulates wall seconds per phase over calls (the
    kernel phase from CUDA events on the card); ``chunks`` counts the
    chunks run."""

    def __init__(
        self, device: str | torch.device = "cuda",
        max_grid_elements: int = 64 * 1024 * 1024,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchBackend: CUDA is not available on this host; pass "
                "device='cpu' to run on the CPU"
            )
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        self.max_grid_elements = int(max_grid_elements)
        self.phase_seconds = dict.fromkeys(PHASES, 0.0)
        self.chunks = 0

    def run_bin_mean(
        self, clusters: list[Cluster], config: BinMeanConfig = BinMeanConfig()
    ) -> list[Spectrum]:
        """One consensus spectrum per cluster, in input order (ref
        src/binning.py:291-297)."""
        check_no_empty(clusters)
        for c in clusters:
            check_uniform_charge(c.members)
        t0 = time.perf_counter()
        batches = pack_flat_bin_mean(
            _as_table(clusters), config,
            max_elements=self.max_grid_elements // 4,
        )
        self.phase_seconds["pack"] += time.perf_counter() - t0
        out: list[Spectrum | None] = [None] * len(clusters)
        for batch in batches:
            fused, aux = self._flat_chunk_dispatch(batch, config)
            t0 = time.perf_counter()
            self._emit_bin_mean_rows(batch, fused, aux, clusters, out)
            self.phase_seconds["finalize"] += time.perf_counter() - t0
        return out

    def _host_run_pass(self, batch, config: BinMeanConfig) -> dict:
        """Per-run host pass over one chunk's sorted composite: counts,
        the oracle-exact integer quorum (int(n*frac)+1, ref
        src/binning.py:183), per-bin m/z means (f32 reduceat in the
        oracle's accumulation order) and per-row output extents."""
        g = batch.gbin
        n = g.size
        rows = len(batch.source_indices)
        starts_idx = batch.run_starts
        counts = np.diff(np.append(starts_idx, n))
        mz_sums = (
            np.add.reduceat(batch.mz, starts_idx)
            if starts_idx.size
            else np.zeros(0, np.float32)
        )
        row_of_run = g[starts_idx].astype(np.int64) // np.int64(
            config.n_bins + 1
        )
        if config.apply_peak_quorum:
            quorum = (
                batch.n_members[row_of_run].astype(np.float64)
                * config.quorum_fraction
            ).astype(np.int64) + 1
        else:
            quorum = np.ones_like(counts)
        keep = counts >= quorum
        # oracle dtype chain: f32 sum promoted to f64 by the int division
        kept_mz = (mz_sums.astype(np.float64) / counts)[keep]
        n_out = np.bincount(row_of_run[keep], minlength=rows)
        row_out_offsets = np.zeros(rows + 1, dtype=np.int64)
        np.cumsum(n_out, out=row_out_offsets[1:])
        return dict(
            kept_mz=kept_mz, row_out_offsets=row_out_offsets, rows=rows,
            keep=keep,
        )

    def _flat_chunk_dispatch(self, batch, config: BinMeanConfig):
        """One chunk: the host run pass, the copy to the card, the kernel
        and the copy back.  Returns ``(kept intensity means (f32 numpy),
        aux)``; the means are exactly ``aux``'s kept runs."""
        ph = self.phase_seconds
        t0 = time.perf_counter()
        aux = self._host_run_pass(batch, config)
        total_cap = int(aux["row_out_offsets"][-1])
        ph["pack"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        args = [
            torch.from_numpy(a).to(self.device)
            for a in (batch.intensity, batch.gbin, aux["keep"])
        ]
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
        ph["h2d"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        if self.device.type == "cuda":
            start.record()
        fused = binning.bin_mean_flat_intensity(
            *args, total_cap=total_cap, rcap=batch.n_distinct_total
        )
        if self.device.type == "cuda":
            end.record()
            end.synchronize()
            ph["kernel"] += start.elapsed_time(end) / 1e3
        else:
            ph["kernel"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        fused = fused.cpu().numpy()
        ph["d2h"] += time.perf_counter() - t0
        self.chunks += 1
        return fused, aux

    def _emit_bin_mean_rows(self, batch, fused, aux, clusters, out) -> None:
        """Assemble one chunk's spectra from the host m/z means and the
        card's intensity means."""
        off = aux["row_out_offsets"]
        kept_mz = aux["kept_mz"]
        for ci in range(aux["rows"]):
            o0, o1 = int(off[ci]), int(off[ci + 1])
            gi = batch.source_indices[ci]
            members = clusters[gi].members
            out[gi] = Spectrum(
                # copies: slices would pin the chunk-wide buffers alive
                mz=kept_mz[o0:o1].copy(),
                intensity=fused[o0:o1].astype(np.float64),
                # exact f64 mean, as the oracle (ref src/binning.py:224)
                precursor_mz=float(
                    np.mean([s.precursor_mz for s in members])
                ),
                precursor_charge=members[0].precursor_charge,
                title=batch.cluster_ids[ci],
            )
