"""The open-loop schedule and the trace reduction, on the CPU."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.kinds import Reservoir
from benchmark.kinds.serve_open import arrivals


def test_schedule_repeats_for_a_seed():
    a, b = arrivals(800, 10, 2**40 + 3), arrivals(800, 10, 2**40 + 3)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, arrivals(800, 10, 2**40 + 4))


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 1])
def test_every_seed_sends_the_same_gaps_over_the_window(seed):
    due = arrivals(800, 10, seed)
    assert len(due) == 8000 and due[0] == 0 and np.all(np.diff(due) > 0)
    assert due[-1] < 10 and due[-1] > 9.9
    ref = np.sort(np.diff(arrivals(800, 10, 12345)))
    gaps = np.sort(np.diff(due))
    # the same quantiles, less the one gap that is not between two arrivals
    assert np.abs(gaps.mean() - ref.mean()) < 0.02 * ref.mean()


def test_reservoir_keeps_a_seeded_uniform_sample():
    def sample(seed):
        r = Reservoir(4, seed)
        for i in range(100):
            r.offer(i)
        return r.items

    assert sample(1) == sample(1) and sample(1) != sample(2) and len(set(sample(1))) == 4


class _Event:
    def __init__(self, name, start, end, cuda=False, annotation=False):
        self._n, self._s, self._e, self._c, self._a = name, start, end, cuda, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_trace_reduction_unions_device_work_and_names_the_gaps():
    events = [
        _Event("bench.window", 0, 1000, annotation=True),
        _Event("bench.window", 0, 1000, cuda=True, annotation=True),  # a GPU annotation span
        _Event("conv3x3_mma_kernel", 100, 300, cuda=True),
        _Event("conv3x3_mma_kernel", 250, 400, cuda=True),  # overlaps on another stream
        _Event("Memcpy DtoH", 600, 700, cuda=True),
        _Event("aten::copy_", 380, 650),
        _Event("cudaStreamSynchronize", 420, 640),
        _Event("Activity Buffer Request", 0, 1000, cuda=True),
    ]
    tr = harness.reduce_trace(events, (0, 1000))
    assert tr["busy_s"] == pytest.approx(400e-9)  # 100-400 and 600-700
    assert tr["kernel_s"] == pytest.approx(300e-9)  # the copy left out
    assert tr["ops"]["conv3x3_mma_kernel"]["launches"] == 2
    assert tr["device_ops"][0][0] == "conv3x3_mma_kernel"
    idle = dict(tr["idle_gaps"])
    assert idle["cudaStreamSynchronize"] == pytest.approx(200e-9)  # 400-600, inside both
    assert idle["(no op)"] == pytest.approx(400e-9)  # 0-100 and 700-1000
