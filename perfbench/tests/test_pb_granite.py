"""The granite-4.0-h cell (``granite4-h-small.w6x4-closed``) on the CPU at a
small size: its configuration file against the catalog's published config,
the plain reference against the port's plain path, the flops by hand, and
the harness end to end through ``run_cell`` reading ``correct`` true.  On a
card (marked ``card``) the cell at its own size passes every limit on
three seeds while the reference in TF32 fails one."""
import copy
import json
import sys
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT
from harness import check
from harness.bench import program_config, run_cell
from harness.cell import family_module, load_cell
from harness.weights import make_weights

CELL = "granite4-h-small.w6x4-closed"
SMALL = {"n_layers": 4, "d_model": 128, "n_heads": 4, "n_kv_heads": 2, "head_dim": 32,
         "d_ff": 64, "vocab_size": 512, "attn_layers": [1, 3], "n_experts": 8,
         "experts_held": 3, "top_k": 3, "shared_expert_ff": 96, "ssm_state": 16,
         "ssm_heads": 8, "ssm_head_dim": 32}
PATTERN = ("mamba2", "attn", "mamba2", "attn")
SEED = 2**31 + 987654321


def small_cell(prompt_len=16):
    """The cell cut to 4 layers (both kinds) of small widths, 3 of 8
    experts held, a batch of 4."""
    cell = load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["sizes"].update(SMALL)
    over = {k: v for k, v in SMALL.items() if k != "attn_layers"}
    cfg["overrides"] = dict(cfg["overrides"], **over, block_pattern=PATTERN)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, prompt_len=prompt_len, batch_size=4, clients=8,
                        sample=32)
    return cell


def test_the_file_holds_the_published_config_and_its_cut():
    """Every key of the catalog's config at the top level, unchanged but the
    experts held (``reduced``); the sizes the program is checked against
    are the published widths."""
    doc = json.loads((BENCH / "configs" / "granite4-h-small-ep4-f32.json").read_text())
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == doc["name"])
    assert entry["reduced"] == ["num_local_experts"] and doc["num_local_experts"] == 18
    assert doc["published"] == {"num_local_experts": 72}
    sz = doc["sizes"]
    assert (sz["d_model"], sz["d_ff"], sz["shared_expert_ff"], sz["ssm_state"],
            sz["ssm_heads"] * sz["ssm_head_dim"]) == (
        doc["hidden_size"], doc["intermediate_size"], doc["shared_intermediate_size"],
        doc["mamba_d_state"], doc["mamba_expand"] * doc["hidden_size"])
    assert sz["attn_layers"] == [i for i, k in enumerate(doc["layer_types"]) if k == "attention"]
    assert (sz["n_experts"], sz["top_k"], sz["vocab_size"], sz["n_layers"]) == (
        72, doc["num_experts_per_tok"], doc["vocab_size"], doc["num_hidden_layers"])
    cfg, _ = program_config(load_cell(CELL))
    assert (cfg.n_held, cfg.n_experts, cfg.pattern.count("mamba2")) == (18, 72, 36)


@pytest.mark.parametrize("seed", [5, 2**33 + 7])
def test_reference_matches_the_port_plain_path(seed):
    from repro_torch.models.zoo import build_model
    cell = small_cell(prompt_len=24)
    cfg, sz = program_config(cell)
    model = build_model(cfg, "cpu")
    params = make_weights(model.abstract_params(torch.float32), cell.config["init"], seed, "cpu")
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (3, 24), dtype=np.int32)
    ref = check.reference_module(cell.config["family"])
    with torch.inference_mode():
        cache = model.init_cache(3, 32, dtype=torch.float32)
        logits, _ = model.prefill(params, {"tokens": torch.from_numpy(tokens)}, cache)
    last = check.reference_logits(ref, params, sz, tokens, "cpu")
    assert (last - logits).abs().max() <= 2e-5 * last.abs().max()
    assert torch.equal(last.argmax(-1), logits.argmax(-1))


def test_flops_of_one_layer_by_hand():
    fl = family_module("flops", "granite_hybrid")
    sz = dict(SMALL, n_layers=2, attn_layers=[1], ssm_expand=2, n_experts=8, experts_held=2)
    rows, seq = 3, 10
    T, d, F, Fs, E, V = rows * seq, 128, 64, 96, 8, 512
    R = T * 3 * 2 / E
    mamba = 2 * T * d * (2 * 256 + 2 * 16 + 8) + 2 * T * 256 * d
    attn = 2 * T * d * (4 * 32 + 2 * 2 * 32) + 2 * T * 4 * 32 * d
    ffn = 2 * T * d * E + 3 * 2 * T * d * Fs + 3 * 2 * R * d * F
    got = fl.pass_counts(sz, rows, seq)
    assert got["matmul"][0] == pytest.approx(mamba + attn + 2 * ffn + 2 * rows * d * V)
    assert got["moe"][0] == pytest.approx(2 * 3 * 2 * R * d * F)
    assert got["ssd_scan"][0] == T * 8 * 4 * 32 * 16
    assert got["flash_attention"][0] == 4 * 32 * (seq * (seq + 1) // 2) * rows * 4
    assert fl.launches(sz) == {"flash_attention": 1, "ssd_scan": 1}


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_on_the_cpu_and_is_correct(trace):
    res = run_cell(small_cell(), SEED, 1.5, trace, "cpu", time.time())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = ({"pass_ms.w6", "mfu.w6"} if trace else {"throughput_rps.w6", "setup_s"})
    assert set(res["metrics"]) == want
    if trace:           # no device time on the CPU: the new readers read nothing
        for name in ("moe_roofline.w6", "ssd_scan_roofline.w6"):
            assert name not in res["metrics"]


@pytest.mark.card
def test_program_passes_and_control_fails_at_full_size(card):
    sys.path.insert(0, str(BENCH / "tools"))
    from calibrate import calibrate
    seeds = (2**31 + 101, 2**31 + 202, 2**31 + 303)
    cell = load_cell(CELL)
    limits = cell.config["limits"]
    for row in calibrate(cell, seeds, set(seeds), 4.0, card, log=lambda m: None):
        assert row["correct"], row
        assert any(row["control"][k] > limits[k] for k in ("logit_err", "token_gap")), row
