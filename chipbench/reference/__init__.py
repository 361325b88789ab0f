"""The plain reference: what the benchmark holds the program's results to.

Plain PyTorch and NumPy only.  It imports neither JAX nor either package
of the system under test, and it takes nothing that the program made: the
benchmark hands it the same inputs that it hands the program."""
