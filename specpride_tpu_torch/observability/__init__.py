"""Run telemetry of the PyTorch/CUDA port (trimmed copies of the JAX
package's ``observability/``):

* ``journal``   — the append-only JSONL event stream (``--journal``), in
                  the JAX package's schema;
* ``registry``  — counters, gauges and histograms, exported as a
                  Prometheus textfile (``--metrics-out``);
* ``exporter``  — the serving daemon's live ``/metrics`` and
                  ``/healthz``, its SLO accounting and the exposition
                  checker;
* ``stats``     — ``RunStats``, logging (``-v``, ``--log-json``) and the
                  ``torch.profiler`` capture (``--trace-dir``);
* ``stats_cli`` — the ``stats`` command over journals;
* ``tracing``   — the span tracer (``--chrome-trace``, the journal's
                  ``span`` events, ``trace``, ``stats --top-spans``);
* ``traceplane``— one causal trace across journal shards (``trace
                  --trace-id``, ``stats --trace``);
* ``detect``, ``flightrec``, ``incident_cli`` — the flight recorder: its
                  detectors, the recorder and its bundles
                  (``--flightrec``), ``incident-replay`` and
                  ``incidents``.
"""
