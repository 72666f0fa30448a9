"""The traffic generator: a seed's prompts repeat exactly, seeds differ,
and every seed gets requests of the mix's one shape."""
import numpy as np
import pytest

from harness.cell import BENCH_DIR, load_json
from harness.traffic import make_schedule

MIXES = sorted(p.stem for p in (BENCH_DIR / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_repeats_and_seeds_differ(mix):
    traffic = load_json(BENCH_DIR / "traffic" / f"{mix}.json")
    a, b = (make_schedule(traffic, 2**31 + 11, 151936) for _ in range(2))
    c = make_schedule(traffic, 2**31 + 12, 151936)
    assert np.array_equal(a.prompts, b.prompts)
    assert not np.array_equal(a.prompts, c.prompts)
    assert a.prompts.shape[1] == traffic["prompt_len"] and a.prompts.max() < 151936
    assert a.clients == traffic["clients"] >= 2 * traffic["batch_size"]
    assert np.array_equal(a.prompt(5), a.prompt(5 + len(a.prompts)))


def test_an_unknown_loop_is_refused():
    with pytest.raises(ValueError):
        make_schedule({"loop": "open", "prompt_len": 4, "clients": 2, "sample": 1}, 1, 16)
