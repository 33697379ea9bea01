"""Splitting work over several cards and several processes."""
