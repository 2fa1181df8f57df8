"""ugpg_tpu_torch: the PyTorch + CUDA port of ugpg_tpu for NVIDIA Hopper.

Serves stage-4 uncertainty-guided segmentation (mask, probabilities and
uncertainty map) on BN-folded weights, and trains the four stages
progressively (``train/seg_trainer.py``).  The kernels on those paths --
the fused DoubleConv, the exact 2x bilinear upsample, the uncertainty map,
and the uncertainty-weighted BCE loss with its gradient -- are
hand-written CUDA C++ for ``sm_90a`` (``csrc/``), each with a plain
PyTorch version beside it (``ops/cuda/``).

Layout mirrors ``ugpg_tpu`` (``models/``, ``ops/``, ``io/``, ``eval/``,
``train/``, ``progressive/``, ``metrics/``, ``data/``, ``utils/``).  The
package imports torch, numpy and the standard library only; it never
imports JAX or ``ugpg_tpu``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from ugpg_tpu_torch.device import resolve_device

__version__ = "0.2.0"

__all__ = ["resolve_device"]
