"""The content-addressed consensus result cache (``--result-cache``):
the local tier of the JAX package's ``cache/``.  See
:mod:`specpride_tpu_torch.cache.result_cache`."""
