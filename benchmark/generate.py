"""The one traffic generator: clustered MS/MS spectra from a traffic file
and a seed, and the harness's own plain MGF writer.

The law of the cluster shapes (members per cluster, peaks per spectrum)
is drawn from the traffic file's fixed ``law_seed``, so every seed gets
the same set of shapes; the run's seed orders them and draws every
value.  Values sit on a decimal grid (``decimals``), so the text the
writer prints parses back to exactly the float64 the reference holds.

As a child process, the set-up's input step::

    python3 -m benchmark.generate TRAFFIC.json SEED OUT.mgf WARM.mgf

writes the warm-up MGF (the job's first ``warmup_clusters`` clusters)
and then the job's MGF, printing one JSON line of sizes and seconds
after each.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing
import sys
import time

import numpy as np

ACCESSION = "PXD004732"
RAW = "01650b_BA5-TUM_first_pool_75_01_01-3xHCD-1h-R2"
BLOCK_PEAKS = 1 << 19  # peak lines formatted per numpy pass
WRITERS = 4  # processes that format peak lines


@dataclasses.dataclass
class Workload:
    """One job's clusters as flat arrays: member ``m``'s peaks are
    ``mz[offsets[m]:offsets[m + 1]]``; cluster ``c``'s members are
    ``member_offsets[c]:member_offsets[c + 1]``."""

    cluster_ids: list
    member_offsets: np.ndarray  # (C + 1,) int64
    offsets: np.ndarray  # (M + 1,) int64
    mz: np.ndarray  # (P,) float64, sorted within each member
    intensity: np.ndarray  # (P,) float64
    precursor_mz: np.ndarray  # (M,) float64
    charge: np.ndarray  # (M,) int64
    rt: np.ndarray  # (M,) float64
    scans: np.ndarray  # (M,) int64
    mz_code: np.ndarray  # (P,) int64: mz * 10**decimals["mz"]
    intensity_code: np.ndarray  # (P,) int64
    decimals: dict

    @property
    def n_clusters(self) -> int:
        return len(self.cluster_ids)

    @property
    def n_spectra(self) -> int:
        return int(self.offsets.size - 1)

    @property
    def n_peaks(self) -> int:
        return int(self.mz.size)

    def cluster_of_member(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_clusters),
                         np.diff(self.member_offsets))

    def member_of_peak(self) -> np.ndarray:
        return np.repeat(np.arange(self.n_spectra), np.diff(self.offsets))

    def head(self, n_clusters: int) -> "Workload":
        """The first ``n_clusters`` clusters."""
        n_clusters = min(n_clusters, self.n_clusters)
        m = int(self.member_offsets[n_clusters])
        p = int(self.offsets[m])
        return Workload(
            self.cluster_ids[:n_clusters],
            self.member_offsets[: n_clusters + 1], self.offsets[: m + 1],
            self.mz[:p], self.intensity[:p], self.precursor_mz[:m],
            self.charge[:m], self.rt[:m], self.scans[:m], self.mz_code[:p],
            self.intensity_code[:p], self.decimals)


def seed_rng(seed: int) -> np.random.Generator:
    """A generator for any whole number, negative or past 64 bits."""
    return np.random.default_rng(int(seed) % (1 << 64))


def shapes(traffic: dict) -> tuple[np.ndarray, np.ndarray]:
    """(members, peaks per spectrum) of each cluster, from the law and
    its fixed seed: the same set for every run seed."""
    rng = np.random.default_rng(int(traffic["law_seed"]))
    n = int(traffic["clusters"])
    law = traffic["members"]
    g = rng.gamma(float(law["shape"]), float(law["scale"]), size=n)
    members = np.minimum(int(law["max"]),
                         int(law["offset"]) + np.floor(g).astype(np.int64))
    peaks = rng.integers(int(traffic["peaks"]["low"]),
                         int(traffic["peaks"]["high"]), size=n)
    return members.astype(np.int64), peaks.astype(np.int64)


def _grid(values: np.ndarray, decimals: int) -> tuple[np.ndarray,
                                                      np.ndarray]:
    """Values on the ``10**-decimals`` grid: (codes, codes / 10**d).  The
    division is correctly rounded, as a parse of the printed decimal is."""
    codes = np.rint(values * 10.0 ** decimals).astype(np.int64)
    return codes, codes / 10.0 ** decimals


def make_workload(traffic: dict, seed: int) -> Workload:
    """One job's clusters from the traffic mix and the seed (the
    ``make_workload`` law of the PXD004732-shaped smoke generator:
    skeleton peaks per cluster, each member the skeleton with Gaussian
    m/z jitter and fresh uniform intensities)."""
    members, peaks = shapes(traffic)
    rng = seed_rng(seed)
    order = rng.permutation(members.size)
    members, peaks = members[order], peaks[order]
    n_clusters = members.size
    mz_lo, mz_hi = float(traffic["mz"]["low"]), float(traffic["mz"]["high"])
    skeleton = rng.uniform(mz_lo, mz_hi, size=int(peaks.sum()))
    sk_off = np.zeros(n_clusters + 1, dtype=np.int64)
    np.cumsum(peaks, out=sk_off[1:])
    for c in range(n_clusters):
        skeleton[sk_off[c]:sk_off[c + 1]].sort()
    charges = rng.choice(np.asarray(traffic["charges"], dtype=np.int64),
                         size=n_clusters)
    member_peaks = np.repeat(peaks, members)
    n_members = int(members.sum())
    offsets = np.zeros(n_members + 1, dtype=np.int64)
    np.cumsum(member_peaks, out=offsets[1:])
    cluster_of_member = np.repeat(np.arange(n_clusters), members)
    # each member's peaks are its cluster's skeleton, in order
    first = sk_off[cluster_of_member]
    idx = (np.arange(int(offsets[-1]))
           - np.repeat(offsets[:-1], member_peaks)
           + np.repeat(first, member_peaks))
    mz = skeleton[idx] + rng.normal(0.0, float(traffic["mz"]["jitter"]),
                                    size=idx.size)
    for m in range(n_members):
        mz[offsets[m]:offsets[m + 1]].sort()
    intensity = rng.uniform(float(traffic["intensity"]["low"]),
                            float(traffic["intensity"]["high"]),
                            size=idx.size)
    precursor = rng.uniform(float(traffic["precursor_mz"]["low"]),
                            float(traffic["precursor_mz"]["high"]),
                            size=n_members)
    dec = traffic["decimals"]
    mz_code, mz = _grid(mz, int(dec["mz"]))
    int_code, intensity = _grid(intensity, int(dec["intensity"]))
    _, precursor = _grid(precursor, int(dec["precursor"]))
    member_offsets = np.zeros(n_clusters + 1, dtype=np.int64)
    np.cumsum(members, out=member_offsets[1:])
    return Workload(
        cluster_ids=[f"cluster-{i}" for i in range(n_clusters)],
        member_offsets=member_offsets, offsets=offsets, mz=mz,
        intensity=intensity, precursor_mz=precursor,
        charge=charges[cluster_of_member],
        rt=cluster_of_member.astype(np.float64),
        scans=np.arange(n_members, dtype=np.int64) + 1000,
        mz_code=mz_code, intensity_code=int_code, decimals=dict(dec))


# -- the plain MGF writer --------------------------------------------------

# the digit at each place of 0-999, as ASCII: _PLACES[k][r] is the k-th
# of r's three digits
_PLACES = [np.array([ord(f"{i:03d}"[k]) for i in range(1000)],
                    dtype=np.uint8) for k in range(3)]


def _digits(v: np.ndarray, width: int, out: np.ndarray) -> None:
    """Write the ASCII digits of non-negative ``v``, zero-padded to
    ``width``, into the rows of ``out`` (width, n), three at a time."""
    col = width
    while col > 0:
        v, r = np.divmod(v, 1000)
        for k in (2, 1, 0):
            col -= 1
            if col < 0:
                break
            out[col] = _PLACES[k][r]


def _width(v: np.ndarray) -> int:
    return len(str(int(v.max()))) if v.size else 1


def peak_lines(mz_code: np.ndarray, int_code: np.ndarray,
               decimals: dict) -> tuple[bytes, np.ndarray]:
    """``"<mz> <intensity>\\n"`` for each peak: the text and each line's
    length.  Each number is ``code / 10**decimals`` in fixed point, its
    integer part without leading zeros.  Built a column of characters at a
    time (one row per character place), then transposed."""
    cols = []
    for codes, dec in ((mz_code, int(decimals["mz"])),
                       (int_code, int(decimals["intensity"]))):
        ipart, frac = np.divmod(codes, 10 ** dec)
        cols.append((ipart, _width(ipart), frac, dec))
    n = mz_code.size
    width = sum(wi + 1 + dec + 1 for _, wi, _, dec in cols)
    chars = np.empty((width, n), dtype=np.uint8)
    keep = np.ones((width, n), dtype=bool)
    at = 0
    for k, (ipart, wi, frac, dec) in enumerate(cols):
        _digits(ipart, wi, chars[at:at + wi])
        np.logical_or.accumulate(chars[at:at + wi] != ord("0"), axis=0,
                                 out=keep[at:at + wi])
        keep[at + wi - 1] = True
        at += wi
        chars[at] = ord(".")
        _digits(frac, dec, chars[at + 1:at + 1 + dec])
        at += 1 + dec
        chars[at] = ord(" ") if k == 0 else ord("\n")
        at += 1
    keep = np.ascontiguousarray(keep.T)
    return (np.ascontiguousarray(chars.T)[keep].tobytes(),
            keep.sum(axis=1))


def _header(w: Workload, m: int, cluster_id: str, dec: int) -> bytes:
    return (f"BEGIN IONS\nTITLE={cluster_id};mzspec:{ACCESSION}:{RAW}:scan:"
            f"{int(w.scans[m])}\nPEPMASS={w.precursor_mz[m]:.{dec}f}\n"
            f"CHARGE={int(w.charge[m])}+\nRTINSECONDS={w.rt[m]:.1f}\n"
            ).encode()


def _block_text(args) -> tuple[bytes, np.ndarray]:
    return peak_lines(*args)


def _spectrum_blocks(w: Workload) -> list[tuple[int, int]]:
    """[m0, m1) member ranges of about ``BLOCK_PEAKS`` peaks each."""
    blocks, m0 = [], 0
    while m0 < w.n_spectra:
        p0 = int(w.offsets[m0])
        m1 = int(np.searchsorted(w.offsets, p0 + BLOCK_PEAKS, "right")) - 1
        m1 = min(max(m1, m0 + 1), w.n_spectra)
        blocks.append((m0, m1))
        m0 = m1
    return blocks


def write_mgf(w: Workload, path: str, pool=None) -> int:
    """Write the clustered MGF (each member's TITLE ``<cluster>;<USI>``),
    its peak lines formatted in blocks (on ``pool``'s workers when
    given); returns the bytes written."""
    dec = int(w.decimals["precursor"])
    owner = np.repeat(np.arange(w.n_clusters), np.diff(w.member_offsets))
    blocks = _spectrum_blocks(w)
    tasks = [(w.mz_code[w.offsets[m0]:w.offsets[m1]],
              w.intensity_code[w.offsets[m0]:w.offsets[m1]], w.decimals)
             for m0, m1 in blocks]
    texts = (pool.imap(_block_text, tasks) if pool is not None
             else map(_block_text, tasks))
    written = 0
    with open(path, "wb") as fh:
        for (m0, m1), (text, lens) in zip(blocks, texts):
            p0 = int(w.offsets[m0])
            ends = np.zeros(lens.size + 1, dtype=np.int64)
            np.cumsum(lens, out=ends[1:])
            pieces = []
            for m in range(m0, m1):
                a = int(ends[w.offsets[m] - p0])
                b = int(ends[w.offsets[m + 1] - p0])
                pieces.append(_header(w, m, w.cluster_ids[owner[m]], dec))
                pieces.append(text[a:b])
                pieces.append(b"END IONS\n\n")
            blob = b"".join(pieces)
            fh.write(blob)
            written += len(blob)
    return written


def main(argv: list[str]) -> int:
    """Write the warm-up MGF, print its line, then the job's MGF and its
    line (the parent warms up while the job's file is written)."""
    traffic_path, seed, out, warm = argv
    t0 = time.perf_counter()
    with open(traffic_path, encoding="utf-8") as fh:
        traffic = json.load(fh)
    w = make_workload(traffic, int(seed))
    gen_s = time.perf_counter() - t0
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(WRITERS) as pool:
        head = w.head(int(traffic["warmup_clusters"]))
        write_mgf(head, warm, pool)
        print(json.dumps({"warmup_clusters": head.n_clusters,
                          "warmup_spectra": head.n_spectra,
                          "warmup_s": time.perf_counter() - t0}), flush=True)
        size = write_mgf(w, out, pool)
    print(json.dumps({
        "clusters": w.n_clusters, "spectra": w.n_spectra,
        "peaks": w.n_peaks, "bytes": size, "generate_s": gen_s,
        "input_s": time.perf_counter() - t0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
