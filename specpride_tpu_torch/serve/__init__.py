"""Serving, as far as the port has it: the configuration digest of
``batcher`` that keys the result cache."""
