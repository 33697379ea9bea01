"""The benchmark of the PyTorch/CUDA port (``specpride_tpu_torch``).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on the card.  Every
configuration, traffic mix, per-layer metric and work model is a file of
its own, found by its name (``benchmark/README.md``).  Nothing here
imports JAX or the JAX package, and ``benchmark/reference/`` imports
nothing of the port.
"""
