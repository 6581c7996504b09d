"""Host-side utilities of the PyTorch/CUDA port: engine configuration and
device resolution.

Importing any subpackage of the port imports this one first, so the
precision pin below holds before any tensor is made: TF32 would truncate
float32 matrix-product operands to a 10-bit mantissa, the Hopper analogue
of the TPU's bf16 operand rounding that the JAX package's ``fused_exact``
exists to undo (``netrep_tpu/ops/fused_gather.py``). The seven statistics
are compared against observed values to count exceedances, so their
products run in full float32.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
