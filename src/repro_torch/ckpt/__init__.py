"""Atomic, mesh-agnostic checkpoints in the JAX package's on-disk format."""
