"""Synthetic training data: a stream that is pure in (seed, step)."""
