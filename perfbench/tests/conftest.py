"""Tests of the benchmark (``perfbench/``), on the CPU at small sizes; those
marked ``card`` run only where CUDA is.  Run from the repository's root:

    python -m pytest perfbench/tests -q

A test decides inside a fixture whether a card is present, never while a
module is imported.
"""
import copy
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(BENCH / "reference"), str(BENCH), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = {
    "dense": {"n_layers": 2, "d_model": 128, "n_heads": 4, "n_kv_heads": 2, "head_dim": 32,
              "d_ff": 256, "vocab_size": 512},
    "rwkv6": {"n_layers": 2, "d_model": 128, "d_ff": 256, "vocab_size": 512,
              "rwkv_head_dim": 32},
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips without one)")
    import torch
    torch.set_num_threads(2)      # the window's pumps stay steady beside other workers


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
    return "cuda"


def small_cell(name: str, prompt_len: int = 16):
    """The manifest's cell ``name`` cut to a few layers of small widths, for
    the CPU: the configuration's sizes and the program's overrides alike."""
    from harness.cell import load_cell
    cell = load_cell(name)
    cfg = copy.deepcopy(cell.config)
    small = SMALL[cfg["family"]]
    cfg["sizes"].update(small)
    cfg["overrides"] = dict(cfg.get("overrides", {}), **small)
    cell.config = cfg
    cell.traffic = dict(cell.traffic, prompt_len=prompt_len)
    return cell


CELLS = ("qwen15-4b.w6-closed", "rwkv6-1.6b.w5-closed")
