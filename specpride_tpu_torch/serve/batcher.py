"""Cross-job micro-batching for the serving daemon (the port's copy of the
JAX package's ``serve/batcher.py``), and the configuration digest the
result cache keys by.

* **Compatibility key** (:func:`batch_key`): jobs may share one pass only
  when one computation serves them all: the same command and method, the
  same constructed method and QC config (:func:`config_digest`, immune to
  flag spelling) and the same chunking of the input.  Anything with
  job-scoped execution (faults, ``--on-error skip``, streamed or mzML
  input, ``--single``, ``--append``, a checkpoint to resume) runs solo.
* **Collection**: the lane that pops an eligible job leads the batch and
  pulls further compatible jobs from the queue (``pop_compatible``: the
  same fair order, quotas and output guard), bounded by
  ``--batch-window`` and ``--batch-max-clusters``.
* **Shared pass** (:func:`compute_shared`): each distinct input is parsed
  once (through the ingest cache), identical inputs are computed once and
  fanned out, the result cache is consulted once on the leader's lane,
  and the misses go through ``TorchBackend.run_shared``.  Each input is
  cut into the chunks its solo run uses (``--checkpoint-every``): on the
  flat layout a chunk's float32 sums round by its layout, so the shared
  pass computes every chunk as its solo run does and the bytes are the
  solo bytes; on the (B, K) layout ``run_shared`` merges them into shared
  dispatches.
* **Scatter**: each job then runs the unchanged CLI body
  (``cli._run_pipeline_command``) against :class:`BatchResultBackend`, a
  read-only view serving the precomputed results by cluster id, so its
  output, QC report and manifest are its solo run's.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os

import numpy as np

# methods whose result is a per-cluster function of the input and config;
# best is left out: its result depends on a per-job score file
BATCHABLE_METHODS = ("bin-mean", "gap-average", "medoid")


def config_digest(args, command: str) -> str | None:
    """Digest of the constructed method (and QC cosine) config: the part
    of a run's argv that must be identical for two runs to give the same
    representative of the same cluster.  Hashing the built config
    objects, not the argv, makes the key immune to flag spelling and
    order.  None when the config does not build (the run itself reports
    the usage error)."""
    from specpride_tpu_torch import cli

    try:
        cfg = cli.method_config(args)
    except (ValueError, SystemExit):
        return None
    parts = [command, args.method, repr(cfg)]
    if getattr(args, "qc_report", None):
        parts.append(repr(cli._cosine_config(args)))
    else:
        parts.append("noqc")
    h = hashlib.blake2b("\x00".join(parts).encode(), digest_size=8)
    return h.hexdigest()


def _eager_input(args) -> bool:
    """True when the job parses its input whole (a list the batch can
    share), as ``cli._load_mgf_clusters`` decides."""
    from specpride_tpu_torch.cli import _STREAM_AUTO_BYTES

    if args.input.endswith(".gz"):
        return False  # the ingest cache refuses .gz: it would parse twice
    mode = (args.stream_clusters or "off").lower()
    if mode == "off":
        return True
    if mode != "auto":
        return False  # an explicit window
    try:
        return os.path.getsize(args.input) < _STREAM_AUTO_BYTES
    except OSError:
        return False  # unreadable: the solo run reports it


def solo_chunk(args) -> int:
    """The chunk size (clusters) of the job's solo run on the flat layout,
    where every batchable method packs ahead, 0 for one chunk
    (``cli.chunk_clusters``)."""
    from specpride_tpu_torch.cli import chunk_clusters

    return chunk_clusters(args, (args.prefetch or 0) > 0, False)


def batch_key(args, command: str) -> tuple | None:
    """The compatibility key admission stamps on a batch-eligible job, or
    None when it must run solo."""
    from specpride_tpu_torch.cli import _is_mzml

    if command not in ("consensus", "select"):
        return None
    if getattr(args, "method", None) not in BATCHABLE_METHODS:
        return None
    if (args.coordinator or args.mesh or args.inject_faults
            or getattr(args, "single", False) or args.on_error == "skip"
            or args.append
            or (args.checkpoint and os.path.exists(args.checkpoint))):
        return None
    if _is_mzml(args.input) or not _eager_input(args):
        return None
    digest = config_digest(args, command)
    if digest is None:
        return None
    return (command, args.method, digest, solo_chunk(args))


def parse_batch_input(args, worker: int) -> list:
    """One member's input, parsed through the ingest cache (the job's own
    run then hits it).  Raises what the parser raises; the member then
    runs solo and reports the error through its own lane."""
    from specpride_tpu_torch import cli
    from specpride_tpu_torch.observability.stats import RunStats

    args._serve_worker = worker  # the daemon's _execute sets it too
    clusters = cli._load_clusters_served(args, RunStats(), None)
    if not isinstance(clusters, list):  # streamed despite eligibility
        raise TypeError("batch members must parse to an eager list")
    return clusters


@dataclasses.dataclass
class SharedResults:
    """One job's share of a shared pass: representatives (and QC cosines
    when the batch runs QC) by cluster id."""

    reps_by_id: dict
    cos_by_id: dict | None


def compute_shared(backend, args0, command: str, entries) -> dict:
    """The batch's one shared pass on the leader's lane.

    ``entries`` is ``[(job, clusters), ...]``; jobs whose parsed input is
    the same object (the ingest cache keeps one list per unchanged file)
    share one computation.  Each input is cut into its solo chunks
    (``batch_key``'s last field); the result cache, when the daemon has
    one, is consulted once per chunk here, and only the misses go to
    ``backend.run_shared``.  Returns ``{job_id: SharedResults}``; raises
    on any failure, and the daemon then runs every member solo."""
    from specpride_tpu_torch import cli
    from specpride_tpu_torch.cache import result_cache

    method = args0.method
    config = cli.method_config(args0)
    cos_config = cli._cosine_config(args0) if args0.qc_report else None
    chunk = solo_chunk(args0)
    parts = list({id(c): c for _, c in entries}.values())
    rc = result_cache.runtime_for(args0, command, backend)
    # the units run_shared computes: each part's chunks, less their hits
    units, hits = [], {}
    for part in parts:
        for lo in range(0, len(part), chunk or len(part) or 1):
            piece = part[lo:lo + chunk] if chunk else part
            consulted = rc.consult(piece) if rc is not None else None
            hit = rc.hit_ids(consulted) if rc is not None else set()
            for cid in hit:
                hits[cid] = consulted[cid]
            miss = [c for c in piece if c.cluster_id not in hit]
            if miss:
                units.append((miss, consulted))
    results = (backend.run_shared(method, [u for u, _ in units], config,
                                  cos_config=cos_config)
               if units else [])
    reps_by_id: dict = {cid: rep for cid, (rep, _, _) in hits.items()}
    cos_by_id: dict = {cid: cos for cid, (_, cos, _) in hits.items()}
    for (miss, consulted), (reps, cosines) in zip(units, results):
        for j, (c, r) in enumerate(zip(miss, reps)):
            reps_by_id[c.cluster_id] = r
            if cosines is not None:
                cos_by_id[c.cluster_id] = float(cosines[j])
        if rc is not None:
            rc.populate(
                (consulted[c.cluster_id][2], reps[j], c,
                 None if cosines is None else float(cosines[j]))
                for j, c in enumerate(miss))
    out: dict = {}
    for job, clusters in entries:
        ids = [c.cluster_id for c in clusters]
        out[job.job_id] = SharedResults(
            reps_by_id={cid: reps_by_id[cid] for cid in ids},
            cos_by_id=({cid: cos_by_id[cid] for cid in ids}
                       if cos_config is not None else None),
        )
    return out


class BatchResultBackend:
    """A job's read-only view over its lane's resident backend, serving
    the shared pass's per-cluster results.

    The job's ``cli._run_pipeline_command`` runs unchanged against it:
    the ``run_*`` entries return the precomputed results for the clusters
    asked, and everything else (attributes, per-job resets, a cluster the
    pass did not cover) goes to the real backend, so a partial share can
    only cost work, never change a result.  ``supports_prepare`` is False:
    there is nothing to pack ahead; the output is the same bytes however
    the job chunks, since every result is looked up by cluster id."""

    # found before __getattr__ forwards: the result cache skips a member's
    # consult behind this view (the leader consulted for the batch)
    is_batch_view = True

    def __init__(self, inner, shared: SharedResults):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_reps", shared.reps_by_id)
        object.__setattr__(self, "_cos", shared.cos_by_id)

    def __getattr__(self, name):
        return getattr(object.__getattribute__(self, "_inner"), name)

    def __setattr__(self, name, value):
        # per-job state (the journal hook) lands on the real backend
        setattr(object.__getattribute__(self, "_inner"), name, value)

    def _lookup(self, clusters):
        reps = object.__getattribute__(self, "_reps")
        out = []
        for c in clusters:
            r = reps.get(c.cluster_id)
            if r is None:
                return None
            out.append(r)
        return out

    def _cos_lookup(self, clusters):
        cos = object.__getattribute__(self, "_cos")
        if cos is None:
            return None
        out = np.zeros(len(clusters), dtype=np.float64)
        for i, c in enumerate(clusters):
            v = cos.get(c.cluster_id)
            if v is None:
                return None
            out[i] = v
        return out

    def supports_prepare(self, method: str) -> bool:
        return False

    def run_bin_mean(self, clusters, config):
        got = self._lookup(clusters)
        if got is not None:
            return got
        return self._inner.run_bin_mean(clusters, config)

    def run_bin_mean_with_cosines(self, clusters, config, cos_config):
        got = self._lookup(clusters)
        cos = self._cos_lookup(clusters)
        if got is not None and cos is not None:
            return got, cos
        return self._inner.run_bin_mean_with_cosines(clusters, config,
                                                     cos_config)

    def run_gap_average(self, clusters, config):
        got = self._lookup(clusters)
        if got is not None:
            return got
        return self._inner.run_gap_average(clusters, config)

    def run_medoid(self, clusters, config):
        got = self._lookup(clusters)
        if got is not None:
            return got
        return self._inner.run_medoid(clusters, config)

    def average_cosines(self, representatives, clusters, config):
        cos = self._cos_lookup(clusters)
        if cos is not None:
            return cos
        return self._inner.average_cosines(representatives, clusters,
                                           config)
