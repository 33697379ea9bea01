"""Run telemetry of the PyTorch/CUDA port (trimmed copies of the JAX
package's ``observability/``):

* ``journal``   — the append-only JSONL event stream (``--journal``), in
                  the JAX package's schema;
* ``registry``  — counters and gauges, exported as a Prometheus
                  textfile (``--metrics-out``);
* ``stats``     — ``RunStats``, logging (``-v``, ``--log-json``) and the
                  ``torch.profiler`` capture (``--trace-dir``);
* ``stats_cli`` — the ``stats`` command over journals.
"""
