"""MaRaCluster cluster-assignment TSV ingest (the port's copy of the JAX
package's ``io/maracluster.py``).

Format: one ``<raw_file>\t<scan>\t...`` line per spectrum, clusters separated
by blank lines.  Two views are needed by the pipeline:

* ``read_maracluster_clusters`` → list of scan lists, one per cluster
  (ref src/binning.py:33-51 read_cluster_list — note the reference appends a
  cluster only when a blank line follows it, so a file not ending in a blank
  line silently drops the last cluster; we keep a trailing non-empty cluster
  and document the divergence).
* ``scan_to_cluster`` → scan → "cluster-N" mapping with 1-based numbering
  (ref src/convert_mgf_cluster.py:33-44 read_clusters; numbering starts at 1
  and increments on every blank line, reproduced exactly, including the quirk
  that consecutive blank lines skip numbers).
"""

from __future__ import annotations

import os


def read_maracluster_clusters(path: str | os.PathLike) -> list[list[int]]:
    """Parse a MaRaCluster TSV into a list of clusters, each a list of scans."""
    clusters: list[list[int]] = []
    cluster: list[int] = []
    with open(path) as fh:
        for line in fh:
            cols = line.split()
            if not cols:
                clusters.append(cluster)
                cluster = []
                continue
            cluster.append(int(cols[1]))
    if cluster:
        # divergence from ref src/binning.py:33-51: keep a trailing cluster
        # that is not followed by a blank line instead of dropping it
        clusters.append(cluster)
    return clusters


def scan_to_cluster(path: str | os.PathLike, prefix: str = "cluster-") -> dict[int, str]:
    """Map scan number → cluster accession ("cluster-1", ...).

    Reproduces ref src/convert_mgf_cluster.py:33-44: the index starts at 1
    and increments on each blank line.
    """
    mapping: dict[int, str] = {}
    index = 1
    with open(path) as fh:
        for line in fh:
            if not line.strip():
                index += 1
            else:
                cols = line.split("\t")
                mapping[int(cols[1])] = f"{prefix}{index}"
    return mapping
