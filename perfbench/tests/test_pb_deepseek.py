"""The DeepSeek-V2-Lite cell (``deepseek-v2-lite.w6-closed``) on the CPU at a
small size: its configuration file against the catalog's published config,
the plain reference against the port's plain path, the flops by hand, and
the harness end to end through ``run_cell`` reading ``correct`` true.  On a
card (marked ``card``) the cell at its own size passes every limit on
three seeds while the reference in TF32 fails one, and at every published
width a prefill and four decode steps through the latent cache agree with
the reference's full forward at each position."""
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

CELL = "deepseek-v2-lite.w6-closed"
# 3 layers: the dense one and 2 MoE layers; 8 experts, top-2; YaRN's ramp
# over the rope columns acts at these positions (original context 16)
SMALL = {"n_layers": 3, "d_model": 128, "n_heads": 4, "n_kv_heads": 4, "head_dim": 48,
         "qk_nope_head_dim": 32, "qk_rope_head_dim": 16, "v_head_dim": 32, "kv_lora_rank": 64,
         "d_ff": 64, "dense_d_ff": 256, "n_experts": 8, "top_k": 2, "shared_expert_ff": 128,
         "vocab_size": 512, "rope_original_max": 16}
SEED = 2**31 + 135792468


def small_cell(prompt_len=16):
    """The cell cut to 3 layers of small widths, a batch of 4."""
    cell = load_cell(CELL)
    cfg = copy.deepcopy(cell.config)
    cfg["sizes"].update(SMALL)
    cfg["overrides"] = dict(SMALL)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, prompt_len=prompt_len, batch_size=4, clients=8,
                        sample=32)
    return cell


def test_the_file_holds_the_published_config_uncut():
    """Every key of the catalog's config at the top level, nothing reduced;
    the sizes the program is checked against are the published widths."""
    doc = json.loads((BENCH / "configs" / "deepseek-v2-lite-f32.json").read_text())
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in manifest["configs"] if c["name"] == doc["name"])
    assert entry["reduced"] == [] and doc["published"] == {}
    sz, rs = doc["sizes"], doc["rope_scaling"]
    assert (sz["d_model"], sz["d_ff"], sz["dense_d_ff"], sz["shared_expert_ff"]) == (
        doc["hidden_size"], doc["moe_intermediate_size"], doc["intermediate_size"],
        doc["n_shared_experts"] * doc["moe_intermediate_size"])
    assert (sz["head_dim"], sz["v_head_dim"], sz["kv_lora_rank"]) == (
        doc["qk_nope_head_dim"] + doc["qk_rope_head_dim"], doc["v_head_dim"],
        doc["kv_lora_rank"])
    assert (sz["n_experts"], sz["top_k"], sz["vocab_size"], sz["n_layers"],
            sz["first_dense_layers"], sz["norm_topk"]) == (
        doc["n_routed_experts"], doc["num_experts_per_tok"], doc["vocab_size"],
        doc["num_hidden_layers"], doc["first_k_dense_replace"], doc["norm_topk_prob"])
    # what the program has no field for: no factor on the gates, and a YaRN
    # table left unscaled (mscale equal to mscale_all_dim); its ramp's ends
    # are rope.py's constants
    assert doc["routed_scaling_factor"] == 1 and rs["mscale"] == rs["mscale_all_dim"]
    const = {k: v["value"] for k, v in doc["constants"].items()}
    assert (sz["rope_factor"], sz["rope_original_max"], const["yarn_beta_fast"],
            const["yarn_beta_slow"], sz["yarn_mscale_all_dim"]) == (
        rs["factor"], rs["original_max_position_embeddings"], rs["beta_fast"],
        rs["beta_slow"], rs["mscale_all_dim"])
    cfg, _ = program_config(load_cell(CELL))
    assert (cfg.n_held, cfg.n_experts, cfg.mla, cfg.n_params()) == (64, 64, True, 15706482176)


@pytest.mark.parametrize("seed", [7, 2**33 + 11])
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


def test_flops_of_one_layer_each_by_hand():
    fl = family_module("flops", "deepseek_mla")
    sz = dict(SMALL, n_layers=2, first_dense_layers=1)
    rows, seq = 3, 10
    T, d, H, E, K, F, Fs, Fd, V = rows * seq, 128, 4, 8, 2, 64, 128, 256, 512
    mla = 2 * T * (d * H * 48 + d * (64 + 16) + 64 * H * (32 + 32) + H * 32 * d)
    dense = 3 * 2 * T * d * Fd
    moe = 2 * T * d * E + 3 * 2 * T * d * Fs + 3 * 2 * T * K * d * F
    got = fl.pass_counts(sz, rows, seq)
    assert got["matmul"][0] == pytest.approx(2 * mla + dense + moe + 2 * rows * d * V)
    assert got["moe"][0] == pytest.approx(3 * 2 * T * K * d * F)
    assert got["moe"][1] >= 4 * 3 * E * d * F          # every expert's weights
    assert got["flash_attention"][0] == 2 * 2 * (48 + 32) * (seq * (seq + 1) // 2) * rows * H
    assert fl.launches(sz) == {"flash_attention": 2}


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_on_the_cpu_and_is_correct(trace):
    res = run_cell(small_cell(), SEED, 1.5, trace, "cpu", time.time())
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    want = ({"pass_ms.w6", "mfu.w6"} if trace else {"throughput_rps.w6", "setup_s"})
    assert set(res["metrics"]) == want


@pytest.mark.card
def test_program_passes_and_control_fails_at_full_size(card):
    sys.path.insert(0, str(BENCH / "tools"))
    from calibrate import calibrate
    seeds = (2**31 + 111, 2**31 + 222, 2**31 + 333)
    cell = load_cell(CELL)
    limits = cell.config["limits"]
    for row in calibrate(cell, seeds, set(seeds), 4.0, card, log=lambda m: None):
        assert row["correct"], row
        assert any(row["control"][k] > limits[k] for k in ("logit_err", "token_gap")), row


@pytest.mark.card
def test_prefill_then_decode_at_published_widths(card):
    """All 27 layers and 64 experts at the cell's weights: 6 prompts of 64
    tokens through ``Model.prefill`` (its graph) and 4 decode steps through
    the latent cache (the absorbed form), each position's logits against
    the reference's full forward over the 68 tokens, within the
    configuration's ``logit_err`` limit."""
    from ref_common import Precision
    from repro_torch.models.zoo import build_model
    cell = load_cell(CELL)
    cfg, sz = program_config(cell)
    model = build_model(cfg, card)
    params = make_weights(model.abstract_params(torch.float32), cell.config["init"], SEED, card)
    tokens = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (6, 68), dtype=np.int32)).to(card)
    ref = check.reference_module(cell.config["family"])
    pr = Precision("float32")
    with torch.inference_mode():
        cache = model.init_cache(6, 80, dtype=torch.float32)
        logits, cache = model.prefill(params, {"tokens": tokens[:, :64]}, cache)
        steps = [logits]
        for t in range(64, 68):
            logits, cache = model.decode_step(params, tokens[:, t:t + 1], cache)
            steps.append(logits[:, 0])
        with pr.active(card):
            want = ref.head(params, ref.hidden(params, sz, tokens, pr)[:, 63:68], pr)
    errs = [float(check.logit_errs(got, want[:, i]).max()) for i, got in enumerate(steps)]
    assert max(errs) <= cell.config["limits"]["logit_err"], errs
