"""Serving: the port's resident daemon (the counterpart of the JAX
package's ``serve/``).

* ``protocol``: the JSON-lines wire format and the flags a job may not
  carry;
* ``scheduler``: the bounded weighted-fair admission queue with quotas
  and the output-path guard;
* ``placement``: the lanes' cards and CUDA streams;
* ``ingest_cache``: parsed inputs kept resident between jobs;
* ``batcher``: cross-job micro-batching, and the configuration digest
  the result cache keys by;
* ``daemon``: boot, accept, execute and drain;
* ``client``: ``submit`` and ``profile``, without torch.

Jobs run through the CLI's own body (``cli._run_pipeline_command``) on a
lane's resident backend, so a served job writes the one-shot CLI's
bytes.
"""
