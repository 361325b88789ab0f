"""Model configurations: ``ModelConfig`` and one file a published model
(copies of the JAX package's, field for field)."""
