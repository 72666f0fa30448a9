"""``correct`` comes out false when the timed path is broken underneath,
and the control (the reference in TF32 in the program's place) fails the
limits.

The harness runs on the CPU (its look for a card skipped), through the
whole window and check, with one of the faults a serving cell can have:
an answer altered where the engine produces it; half of the batch left
out, its rows given the mean of the rest; a pass that returns its state
unchanged (the previous pass's logits).  No exchange between chips exists
in a one-card cell.
"""
import time

import numpy as np
import pytest
import torch

from conftest import CELLS, small_cell
from harness import check
from harness.bench import program_config, run_cell
from harness.traffic import make_schedule
from harness.weights import make_weights

SEED = 3_000_000_017


def _altered_answer(monkeypatch):
    from repro_torch.serving.engine import ServingEngine
    serve = ServingEngine._serve

    def faulty(self, tokens):
        out = serve(self, tokens)
        out[0, 0] = (out[0, 0] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(ServingEngine, "_serve", faulty)


def _half_batch(monkeypatch):
    from repro_torch.models.zoo import Model
    prefill = Model.prefill

    def faulty(self, params, batch, cache, **kw):
        logits, cache = prefill(self, params, batch, cache, **kw)
        h = max(1, logits.shape[0] // 2)
        logits = logits.clone()
        logits[h:] = logits[:h].mean(0)
        return logits, cache
    monkeypatch.setattr(Model, "prefill", faulty)


def _state_unchanged(monkeypatch):
    from repro_torch.models.zoo import Model
    prefill = Model.prefill
    last = []

    def faulty(self, params, batch, cache, **kw):
        logits, cache = prefill(self, params, batch, cache, **kw)
        out = last[-1] if last else logits
        last.append(logits)
        return out, cache
    monkeypatch.setattr(Model, "prefill", faulty)


FAULTS = {"altered_answer": _altered_answer, "half_batch": _half_batch,
          "state_unchanged": _state_unchanged}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = small_cell(name)
    FAULTS[fault](monkeypatch)
    res = run_cell(cell, SEED, 1.5, False, "cpu", time.time())
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_far_above_sound_runs(name):
    """The reference in TF32 (operands rounded to 10 mantissa bits on the
    CPU) in the program's place, on a sample of the cell's prompts, reads a
    hundred times the program's ``logit_err`` or more.  The limits are set
    for the cells' full sizes, where the control reads 2.1e-3 (qwen1.5-4b)
    and 0.12 (rwkv6-1.6b); ``test_pb_card.py`` holds it to them there."""
    cell = small_cell(name, prompt_len=32)
    res = run_cell(cell, SEED, 1.5, False, "cpu", time.time())
    from repro_torch.models.zoo import build_model
    cfg, sz = program_config(cell)
    params = make_weights(build_model(cfg, "cpu").abstract_params(torch.float32),
                          cell.config["init"], SEED, "cpu")
    sched = make_schedule(cell.traffic, SEED, cfg.vocab_size)
    prompts = np.stack([sched.prompt(r) for r in res["sample"]])
    ref = check.reference_module(cell.config["family"])
    ctrl = check.control_numbers(ref, params, sz, prompts, "cpu")
    sound = max(res["checks"]["logit_err"]["value"], 1e-7)
    assert res["correct"] and ctrl["logit_err"] > 100 * sound, (ctrl, sound)
