"""The plain references against the port's plain path, at a small size on
the CPU: the same weights and prompts give the same final hidden states
and the same last-position logits."""
import numpy as np
import pytest
import torch

from conftest import CELLS, small_cell
from harness import check
from harness.bench import program_config
from harness.weights import make_weights

TOL = 2e-5          # of the largest value: float32 over two layers, sums in other orders


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [5, 2**33 + 7])
def test_reference_matches_the_port_plain_path(name, seed):
    from repro_torch.models.zoo import build_model
    cell = small_cell(name, prompt_len=40)
    cfg, sz = program_config(cell)
    model = build_model(cfg, "cpu")
    params = make_weights(model.abstract_params(torch.float32), cell.config["init"], seed, "cpu")
    tokens = np.random.default_rng(seed).integers(0, cfg.vocab_size, (3, 40), dtype=np.int32)
    toks = torch.from_numpy(tokens)
    ref = check.reference_module(cell.config["family"])
    from ref_common import Precision
    pr = Precision("float32")
    with torch.inference_mode():
        h_ref = ref.hidden(params, sz, toks, pr)
        h_port, _ = model.forward(params, {"tokens": toks})
        cache = model.init_cache(3, 48, dtype=torch.float32)
        logits, _ = model.prefill(params, {"tokens": toks}, cache)
    assert (h_ref - h_port).abs().max() <= TOL * h_ref.abs().max()
    last = check.reference_logits(ref, params, sz, tokens, "cpu")
    assert (last - logits).abs().max() <= TOL * last.abs().max()
    assert torch.equal(last.argmax(-1), logits.argmax(-1))


def test_tf32_rounding_keeps_ten_mantissa_bits():
    from ref_common import round_tf32
    x = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-11, 1.0 + 2**-12, -3.0 - 2**-9])
    got = round_tf32(x)
    assert got.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, 1.0, -3.0 - 2**-9]
