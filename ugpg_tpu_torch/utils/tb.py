"""Optional TensorBoard event logging (counterpart of ``ugpg_tpu/utils/tb.py``).

Both trainers take ``tb_logdir=`` and write per-epoch scalars through
``torch.utils.tensorboard.SummaryWriter``, which needs the ``tensorboard``
package.  Where it cannot be imported, the writer is a no-op and warns
once; the port does not need the package.
"""

from __future__ import annotations

import warnings

__all__ = ["TBWriter"]


class TBWriter:
    """Scalar-only TensorBoard writer; a no-op if the backend is absent."""

    def __init__(self, logdir):
        self._w = None
        if logdir is None:
            return
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(str(logdir))
        except ImportError as e:  # no tensorboard package
            warnings.warn(
                f"tb_logdir={logdir!r} requested but the TensorBoard writer "
                f"is unavailable ({e}); event logging disabled",
                stacklevel=2,
            )

    @property
    def active(self) -> bool:
        return self._w is not None

    def scalars(self, step: int, **values) -> None:
        """Write ``values`` (floats) at ``step``; tag = the keyword's name."""
        if self._w is None:
            return
        for tag, value in values.items():
            self._w.add_scalar(tag, float(value), step)

    def close(self) -> None:
        if self._w is not None:
            self._w.close()
            self._w = None
