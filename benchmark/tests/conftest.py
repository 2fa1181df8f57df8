"""CPU tests of the benchmark: the repository's root on the path, and the
port narrowed (a width multiplier, smaller stage resolutions) so that a
cell runs here in seconds."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

WIDTH = 0.125
SCALES = {
    "seg4-serve-bulk": {"width": WIDTH, "resolution": 64, "batch": 2, "pool_batches": 2,
                        "check_calls": 2},
    "cls4-serve-bulk": {"resolution": 32, "batch": 8, "pool_batches": 2, "check_calls": 2},
    "seg4-train-b8": {"width": WIDTH, "resolution": 64, "batch": 2, "dataset": 8},
    "seg4-serve-open": {"width": WIDTH, "resolution": 64, "pool_images": 64, "rate_per_s": 400,
                        "check_requests": 16},
}


@pytest.fixture
def small_port(monkeypatch):
    """The port's serving stages at width ``WIDTH``, stage 4 at 64 px and
    the classifier's stage 4 at 32 px, as ``SCALES`` shrink the cells."""
    import torch

    torch.set_num_threads(4)
    from ugpg_tpu_torch.models import classifier, pgunet

    for stage in (3, 4):
        model = pgunet.STAGE_MODELS[stage]
        monkeypatch.setitem(pgunet.STAGE_MODELS, stage,
                            lambda _m=model, **kw: _m(**{"width": WIDTH, **kw}))
    monkeypatch.setitem(pgunet.STAGE_RESOLUTIONS, 4, 64)
    monkeypatch.setitem(classifier.CLS_STAGE_RESOLUTIONS, 4, 32)
    return SCALES
