"""The comparison that decides ``correct``: the port's output MGF and QC
report, read back by the harness's own reader, against the plain
reference run on the harness's own clusters.

Numbers compared (each beside its limit in the configuration's
``check.limits``):

- ``mismatched_reps``: clusters whose representative is missing, out of
  order, or differs in title, charge or peak count, and QC rows missing
  or differing in member count (exact: limit 0).  The expected title is
  the reference's (``Reps.titles``: a selection's chosen member's own),
  else the cluster id; QC rows are keyed by cluster id;
- ``peak_gap``: the widest relative gap of a matched representative's
  m/z, intensity, precursor m/z or RT from the reference's;
- ``cosine_gap``: the widest absolute gap of a QC row's mean cosine from
  the reference's (configurations with a QC report).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np


@dataclasses.dataclass
class Output:
    """An MGF's records as flat arrays."""

    titles: list
    offsets: np.ndarray
    mz: np.ndarray
    intensity: np.ndarray
    pepmass: np.ndarray
    charge: np.ndarray
    rt: np.ndarray


def _charge(text: str) -> int:
    text = text.strip()
    if text.endswith("-"):
        return -int(text[:-1])
    return int(text.rstrip("+"))


def read_mgf(path: str) -> Output:
    """The harness's own plain MGF reader: TITLE, PEPMASS, CHARGE and
    RTINSECONDS of each record, and its peak lines."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    titles, counts, pepmass, charge, rt, peaks = [], [], [], [], [], []
    for record in text.split("BEGIN IONS\n")[1:]:
        body = record[: record.index("END IONS")]
        head = {}
        at = 0
        while at < len(body) and not (body[at].isdigit()
                                      or body[at] in "+-."):
            end = body.index("\n", at)
            key, _, value = body[at:end].partition("=")
            head[key] = value
            at = end + 1
        lines = body[at:]
        titles.append(head.get("TITLE", ""))
        pepmass.append(float(head.get("PEPMASS", "0").split()[0]))
        charge.append(_charge(head["CHARGE"]) if "CHARGE" in head else 0)
        rt.append(float(head.get("RTINSECONDS", 0.0)))
        counts.append(lines.count("\n"))
        peaks.append(lines)
    values = np.array(" ".join(peaks).split(), dtype=np.float64)
    off = np.zeros(len(counts) + 1, dtype=np.int64)
    np.cumsum(counts, out=off[1:])
    if values.size != 2 * off[-1]:
        raise ValueError(f"{path}: peak lines without two numbers")
    return Output(titles, off, values[0::2], values[1::2],
                  np.array(pepmass), np.array(charge, dtype=np.int64),
                  np.array(rt))


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    if got.size == 0:
        return 0.0
    scale = np.maximum(np.abs(want), np.finfo(np.float64).tiny)
    return float(np.max(np.abs(got - want) / scale))


def compare(out: Output, qc: dict | None, ref, cluster_ids: list,
            n_members: np.ndarray) -> dict:
    """The numbers compared, over every cluster of the job."""
    n = len(cluster_ids)
    rn = np.diff(ref.offsets)
    mismatched = abs(len(out.titles) - n)
    m = min(len(out.titles), n)
    on = np.diff(out.offsets)[:m]
    want = cluster_ids if ref.titles is None else ref.titles
    same = np.array([out.titles[i] == want[i] for i in range(m)],
                    dtype=bool)
    same &= out.charge[:m] == ref.charge[:m]
    same &= on == rn[:m]
    mismatched += int((~same).sum())
    # matched records' peaks, side by side
    idx = np.flatnonzero(same)
    take_o = np.repeat(out.offsets[idx], on[idx]) + _ramp(on[idx])
    take_r = np.repeat(ref.offsets[idx], on[idx]) + _ramp(on[idx])
    gaps = [_rel(out.mz[take_o], ref.mz[take_r]),
            _rel(out.intensity[take_o], ref.intensity[take_r]),
            _rel(out.pepmass[idx], ref.pepmass[idx]),
            _rel(out.rt[idx], ref.rt[idx])
            if np.any(ref.rt[idx]) else 0.0]
    numbers = {"mismatched_reps": mismatched, "peak_gap": max(gaps)}
    if ref.cosines is not None:
        rows = (qc or {}).get("clusters", [])
        got = {r["cluster_id"]: r for r in rows}
        gap = 0.0
        for i, cid in enumerate(cluster_ids):
            row = got.get(cid)
            if row is None or int(row["n_members"]) != int(n_members[i]):
                numbers["mismatched_reps"] += 1
                continue
            gap = max(gap, abs(float(row["avg_cosine"])
                               - float(ref.cosines[i])))
        numbers["cosine_gap"] = gap
    return numbers


def _ramp(lengths: np.ndarray) -> np.ndarray:
    """0..len-1 for each length, concatenated."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    starts = np.cumsum(lengths) - lengths
    return np.arange(total) - np.repeat(starts, lengths)


def judge(numbers: dict, limits: dict) -> bool:
    """Every number at or under its limit (a missing number fails)."""
    return all(name in numbers and numbers[name] <= limit
               for name, limit in limits.items())


def read_qc(path: str | None) -> dict | None:
    if path is None:
        return None
    with open(path, encoding="utf-8") as fh:
        return json.load(fh)
