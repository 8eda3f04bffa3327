"""The comparison that decides ``correct`` can fail: the control (the
reference in the program's place, comparing differences modulo the
element width) comes out not correct, and so does a run whose timed path
alters an answer where it is produced.  The unbroken run passes."""

import numpy as np
import pytest

from bench_small import CELLS, overrides
from benchmark import control, harness, spec


@pytest.mark.parametrize("name", CELLS)
def test_control_comes_out_not_correct(name):
    cell = spec.cell(name)
    result = control.run(cell, 2**31 + 3, 60.0, "cpu",
                         overrides=overrides(cell), max_requests=40)
    checks = result["checks"]["requests_wrong"]
    assert result["attempted"] == 40 and checks["compared"] in (24, 25)
    assert checks["value"] >= 1 and result["correct"] is False


def shift_first_offset(real):
    """The fused step's answer altered: its first match one element on."""
    def step(pending):
        offs, vals, info = real(pending)
        if len(offs):
            offs = np.array(offs, copy=True)
            offs[0] += 1
        return offs, vals, info
    return step


def bump_first_value(real):
    """The fused step's recovery values altered: the values map is off."""
    def step(pending):
        offs, vals, info = real(pending)
        if len(vals):
            vals = np.array(vals, copy=True)
            vals[0] = vals[0] + 1
        return offs, vals, info
    return step


def alter_preview(real):
    """A preview altered where the engine makes it."""
    def preview(*args, **kwargs):
        text = real(*args, **kwargs)
        return text[:-1] + ("#" if not text.endswith("#") else "?")
    return preview


FAULTS = {
    "none": None,
    "offset": ("fused_count_extract_finish", shift_first_offset),
    "values": ("fused_count_extract_finish", bump_first_value),
    "preview": ("generate_preview", alter_preview),
}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_run_with_an_answer_altered_is_not_correct(name, fault, monkeypatch):
    from monkey_moore_tpu_torch import engine

    if FAULTS[fault] is not None:
        attr, wrap = FAULTS[fault]
        monkeypatch.setattr(engine, attr, wrap(getattr(engine, attr)))
    cell = spec.cell(name)
    result = harness.run(cell, 2**31 + 5, 60.0, False, device="cpu",
                         overrides=overrides(cell), max_requests=3)
    assert result["attempted"] == 3
    assert result["correct"] is (fault == "none"), result["checks"]
    assert list(result)[-1] == "checks"


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct_and_the_control_is_not():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.cell("u8_sparse")
    result = harness.run(cell, 2**31 + 11, 2.0, False, device="cuda")
    assert result["correct"] and result["device"]["platform"] == "gpu"
    control_result = control.run(cell, 2**31 + 11, 2.0, "cuda")
    assert control_result["correct"] is False
