"""The one traffic generator: a mix's parameters and the run's seed in, the
requests out.  A mix is a data file, ``traffic/<name>.json``:

- ``loop``: ``"closed"``, ``clients`` callers, each sending its next
  request when its last one is answered (the only loop the harness runs);
- ``batch_size``, ``prompt_len``, ``decode_tokens``: the engine's settings
  for the mix's App workload;
- ``sample``: requests the correctness check compares (``serve.Keeper``
  draws them from the seed).

A seed changes the prompts, not the amount of work: every request has the
mix's shape.  Draws follow numpy's ``default_rng([seed, stream])``, as the
App study's generators do.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

PROMPT_STREAM, SAMPLE_STREAM = 1, 3
CLOSED_POOL = 8192          # prompts a closed loop cycles through


@dataclasses.dataclass
class Schedule:
    prompts: np.ndarray                 # (pool, prompt_len) int32
    clients: int                        # callers
    seed: int
    sample: int

    def prompt(self, rid: int) -> np.ndarray:
        return self.prompts[rid % len(self.prompts)]


def make_schedule(traffic: Dict, seed: int, vocab: int) -> Schedule:
    if traffic["loop"] != "closed":
        raise ValueError(f"unknown loop {traffic['loop']!r}")
    draw = np.random.default_rng([int(seed), PROMPT_STREAM])
    prompts = draw.integers(0, vocab, size=(CLOSED_POOL, int(traffic["prompt_len"])),
                            dtype=np.int32)
    return Schedule(prompts, int(traffic["clients"]), int(seed), int(traffic["sample"]))
