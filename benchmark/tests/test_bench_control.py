"""The correctness check has to fail what is not correct.

- The control (`control.py`): one precision step below the configuration
  (the program's own fp8 weight path for a bf16 configuration; the
  reference with int4 weights in the program's place for an fp8 one)
  reads far above the program on the same seed.
- Faults planted under a whole run, with each cell's own limits: a step
  that returns its state unchanged, half of the UNet's batch left out with
  the mean of the rest in its place, and an answer altered where it is
  produced. A one-chip cell has no exchange between chips to leave out.

On the CPU at the tiny widths; the `cuda` test runs the control at each
cell's own size.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import control
import harness

SPEC = harness.load_spec()
HERE = os.path.dirname(os.path.abspath(__file__))


def _tiny(cell):
    w, _, _, limits = harness.cell_inputs(SPEC, cell)
    cfg = harness.load_json(os.path.join(HERE, "tiny_config.json"))
    cfg["use_fp8"] = harness.cell_inputs(SPEC, cell)[1]["use_fp8"]
    return w, cfg, harness.load_json(os.path.join(HERE, "tiny_traffic.json")), limits


def _run(cell, seed, **kw):
    result, _, error = harness.run_cell(cell, seed, 0.1, False, "cpu", SPEC,
                                        inputs=_tiny(cell), **kw)
    assert error is None
    return result


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_reads_far_above_the_program(cell):
    seed = 424_242
    sound = _run(cell, seed)
    ctl = control.run_control(cell, seed, 0.1, "cpu", SPEC, inputs=_tiny(cell))
    assert sound["correct"] is True
    got = sound["check"]["latent_rel_l2"]["value"]
    want = ctl["check"]["latent_rel_l2"]["value"]
    assert want > 100 * got and want > 1e-3, (got, want)


def _faulty_step(monkeypatch):
    from faithdiff_tpu_torch.schedulers import EulerDiscreteScheduler

    monkeypatch.setattr(EulerDiscreteScheduler, "step",
                        lambda self, state, out, i, sample: sample)


def _half_batch(monkeypatch):
    from faithdiff_tpu_torch.models.unet import UNet2DConditionModel

    forward = UNet2DConditionModel.forward

    def half(self, sample, t, ctx, text, ids, lq=None, add_sample=True,
             fusion_group_size=None):
        h = sample.shape[0] // 2
        eps = forward(self, sample[:h], t, ctx[:h], text[:h], ids[:h],
                      None if lq is None else lq[:h], add_sample, fusion_group_size)
        rest = eps.mean(0, keepdim=True).expand(sample.shape[0] - h, *eps.shape[1:])
        return torch.cat([eps, rest])

    monkeypatch.setattr(UNet2DConditionModel, "forward", half)


def _altered_answer(monkeypatch):
    from faithdiff_tpu_torch.pipelines.faithdiff import FaithDiffPipeline

    decode = FaithDiffPipeline.decode

    def altered(self, *args, **kwargs):
        out = decode(self, *args, **kwargs).copy()
        out[:32, :32] = 255 - out[:32, :32]       # one 32 x 32 patch inverted
        return out

    monkeypatch.setattr(FaithDiffPipeline, "decode", altered)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
@pytest.mark.parametrize("fault", [_faulty_step, _half_batch, _altered_answer])
def test_faults_come_out_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    assert _run(cell, 77)["correct"] is False


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_control_at_the_cells_size_is_not_correct(cell, card):
    for seed in (2_147_483_659, 3_221_225_473, 4_294_967_311):
        assert control.run_control(cell, seed)["correct"] is False
