"""ugpg_tpu_torch: the PyTorch + CUDA port of ugpg_tpu for NVIDIA Hopper.

Serves stage-4 uncertainty-guided segmentation (mask, probabilities and
uncertainty map) on BN-folded weights.  The three kernels on that path --
the fused DoubleConv, the exact 2x bilinear upsample and the uncertainty
map -- are hand-written CUDA C++ for ``sm_90a`` (``csrc/``), each with a
plain PyTorch version beside it (``ops/cuda/``).

Layout mirrors ``ugpg_tpu`` (``models/``, ``ops/``, ``io/``, ``eval/``).
The package imports torch, numpy and the standard library only; it never
imports JAX or ``ugpg_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from ugpg_tpu_torch.device import resolve_device

__version__ = "0.1.0"

__all__ = ["resolve_device"]
