"""The plain reference the benchmark holds the port to: PyTorch and NumPy
only. Nothing here imports ``jax``, ``netrep_tpu`` or ``netrep_tpu_torch``
(the benchmark's tests check it), and nothing takes what the program made:
every function works from the inputs the benchmark drew."""
