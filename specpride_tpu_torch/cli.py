"""Command line of the port: ``python -m specpride_tpu_torch consensus IN
OUT --method bin-mean``.  Reads the clustered MGF, groups it into
clusters, runs the binned-mean consensus on the card (``--device cpu``
for the CPU) and writes one consensus spectrum per cluster."""

from __future__ import annotations

import argparse

from specpride_tpu_torch.backends.torch_backend import TorchBackend
from specpride_tpu_torch.config import BinMeanConfig
from specpride_tpu_torch.data.peaks import group_into_clusters
from specpride_tpu_torch.io.mgf import read_mgf, write_mgf


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="specpride_tpu_torch",
        description="representative spectra on an NVIDIA GPU (PyTorch/CUDA)",
    )
    sub = ap.add_subparsers(dest="command", required=True)
    pc = sub.add_parser("consensus",
                        help="merge clusters into consensus spectra")
    pc.add_argument("input")
    pc.add_argument("output")
    pc.add_argument("--method", choices=["bin-mean"], default="bin-mean")
    pc.add_argument("--min-mz", type=float, default=100.0)
    pc.add_argument("--max-mz", type=float, default=2000.0)
    pc.add_argument("--bin-size", type=float, default=0.02)
    pc.add_argument("--no-quorum", action="store_true")
    pc.add_argument("--quorum-fraction", type=float, default=0.25)
    pc.add_argument(
        "--tolerance-mode", choices=["da", "ppm"], default="da",
        help="bin-mean grid: fixed-Da bins (reference) or "
        "mass-proportional ppm bins",
    )
    pc.add_argument("--ppm", type=float, default=20.0,
                    help="bin width in ppm for --tolerance-mode ppm")
    pc.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the consensus runs (default: the GPU)")
    return ap


def cmd_consensus(args, backend: TorchBackend) -> int:
    config = BinMeanConfig(
        min_mz=args.min_mz,
        max_mz=args.max_mz,
        bin_size=args.bin_size,
        apply_peak_quorum=not args.no_quorum,
        quorum_fraction=args.quorum_fraction,
        tolerance_mode=args.tolerance_mode,
        ppm=args.ppm,
    )
    clusters = group_into_clusters(read_mgf(args.input))
    write_mgf(backend.run_bin_mean(clusters, config), args.output)
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        backend = TorchBackend(device=args.device)
    except RuntimeError as exc:  # no CUDA for the default --device cuda
        ap.error(f"{exc} (here: --device cpu)")
    return cmd_consensus(args, backend)
