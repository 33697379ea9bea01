"""Plain NumPy references of the port's methods, in float64, over a whole
job's clusters at once (``benchmark.generate.Workload``).  They follow
the specpride reference scripts (``src/binning.py``,
``src/average_spectrum_clustering.py``, ``src/benchmark.py``) and import
nothing of the port: each works from the harness's own clusters, never
from what the port made.  A configuration names its reference
(``reference`` in its file) and ``benchmark.spec.Cell.reference`` imports
this package's module of that name; each such module has
``run(workload, config)``."""
