"""User-facing model layer of the PyTorch/CUDA port: dataset containers,
the ``module_preservation`` orchestrator and result shaping.

``netrep_tpu_torch`` itself deliberately has no ``__init__.py``: it is a
namespace package. The JAX package's packaging test discovers
``netrep_tpu*`` with ``setuptools.find_packages`` and expects exactly the
subpackages of ``netrep_tpu``; ``find_packages`` does not descend into a
directory without ``__init__.py``, so the port stays out of that count
while ``import netrep_tpu_torch.models.preservation`` works as usual.
"""

from .. import utils  # noqa: F401  (pins full-float32 matrix products)
