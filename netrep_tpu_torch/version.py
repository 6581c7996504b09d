"""The port's version: the JAX package's release it ports, kept equal to
``pyproject.toml``'s (tested)."""

__version__ = "0.1.0"
