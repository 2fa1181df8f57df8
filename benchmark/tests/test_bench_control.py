"""The comparison fails what it must: each cell's control (the program's
int8 path, the float8 reference, the bfloat16 trainer) and the faults a
cell can have, planted in the port under a run driven on the CPU past
the harness's look for a chip, at a size a test run holds."""

import pytest

from benchmark import faults, harness

SEED = 2**33 + 17


def _run(scales, cell, control=False):
    return harness.run(cell, SEED, 0.5, False, device="cpu", scale=scales[cell],
                       control=control, log=lambda s: None)


@pytest.mark.parametrize("cell", ["seg4-serve-bulk", "cls4-serve-bulk", "seg4-train-b8",
                                  "seg4-serve-open"])
def test_sound_runs_are_correct(small_port, cell):
    assert _run(small_port, cell)["correct"]


@pytest.mark.parametrize("cell", ["seg4-serve-bulk", "cls4-serve-bulk", "seg4-train-b8",
                                  "seg4-serve-open"])
def test_the_control_is_not_correct(small_port, cell):
    r = _run(small_port, cell, control=True)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,fault", [
    ("seg4-serve-bulk", "altered"), ("seg4-serve-bulk", "half"),
    ("cls4-serve-bulk", "altered"), ("cls4-serve-bulk", "half"),
    ("seg4-serve-open", "altered"), ("seg4-serve-open", "half_group"),
])
def test_a_broken_answer_is_not_correct(small_port, monkeypatch, cell, fault):
    faults.plant(monkeypatch, fault)
    r = _run(small_port, cell)
    assert not r["correct"], r["checks"]


def test_a_step_that_leaves_the_state_unchanged_is_not_correct(small_port, monkeypatch):
    faults.plant(monkeypatch, "unchanged")
    r = _run(small_port, "seg4-train-b8")
    assert not r["correct"] and r["checks"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_of_the_batch_left_out_is_not_correct(small_port, monkeypatch):
    faults.plant(monkeypatch, "half_batch")
    r = _run(small_port, "seg4-train-b8")
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("cell,metric", [("seg4-train-b8", "prefetch_wait_ms.train"),
                                         ("seg4-serve-open", "mean_group.request")])
def test_a_traced_run_reads_its_counters_from_the_untraced_window(small_port, cell, metric):
    r = harness.run(cell, SEED, 0.5, True, device="cpu", scale=small_port[cell],
                    log=lambda s: None)
    assert r["correct"], r["checks"]
    assert r["metrics"][metric]["value"] >= 0
    # the device's numbers are the card's alone: none from a run on the CPU
    assert not any(k.startswith(("device_idle", "mfu", "roofline")) for k in r["metrics"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
