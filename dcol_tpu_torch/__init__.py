"""dcol_tpu_torch: the PyTorch / CUDA port of ``dcol_tpu``.

Same capabilities as the JAX package (batched PDIP conic solves for
differentiable proximity between convex primitives, envelope-theorem
gradients, and an AL-iLQR (ALTRO) trajectory optimiser over a batch of
scenarios), written as plain functions on torch tensors.  The one hot kernel,
the fused PDIP solver, is hand-written CUDA C++ for Hopper
(``csrc/pdip.cu``, bound in :mod:`dcol_tpu_torch.ops.pdip_cuda`); tensors on
the CPU take its plain PyTorch version (:mod:`dcol_tpu_torch.ops.pdip`).
"""

import torch as _torch

# The interior-point and Riccati linear algebra works on tiny (<=13x6)
# ill-conditioned matrices; TF32 keeps ~10 mantissa bits and breaks the
# normal-equation Cholesky near convergence.  Full f32 costs nothing at these
# sizes.  (Counterpart of dcol_tpu/__init__.py's "highest" matmul precision.)
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

__version__ = "0.1.0"
