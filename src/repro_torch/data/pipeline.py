"""Data pipeline: tokenized-document stream -> packed training batches.

Offline container => the corpus source is synthetic-but-structured: a
Zipfian n-gram "language" with document boundaries, so cross-entropy is
meaningfully learnable (tests assert loss decreases).  Real deployments
swap `DocumentSource` for a file-backed source; everything downstream
(packing, batching, modality stubs) is production-shaped.

The JAX package's ``data/pipeline.py``, copied: numpy only, so both
packages draw the same batches from the same seed.  It yields numpy
arrays; the training loop moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig

BOS = 1
EOS = 2


class DocumentSource:
    """Synthetic Zipfian bigram documents (learnable structure)."""

    def __init__(self, vocab_size: int, seed: int = 0, *,
                 mean_len: int = 256, n_states: int = 64):
        self.vocab = vocab_size
        self.rng = np.random.default_rng(seed)
        self.mean_len = mean_len
        # a sparse bigram transition structure to learn
        self.n_states = n_states
        self.state_tokens = self.rng.integers(
            3, vocab_size, size=(n_states, 32))
        self.transitions = self.rng.integers(0, n_states, size=(n_states, 4))

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            length = max(8, int(self.rng.exponential(self.mean_len)))
            state = int(self.rng.integers(0, self.n_states))
            toks = [BOS]
            for _ in range(length):
                toks.append(int(self.state_tokens[
                    state, self.rng.integers(0, 32)]))
                state = int(self.transitions[
                    state, self.rng.integers(0, 4)])
            toks.append(EOS)
            yield np.asarray(toks, np.int32)


class PackedBatcher:
    """Packs documents into fixed (batch, seq) token blocks with next-token
    labels; documents are concatenated, EOS-delimited (GPT-style packing)."""

    def __init__(self, source: Iterator[np.ndarray], batch: int, seq: int):
        self.source = iter(source)
        self.batch = batch
        self.seq = seq
        self._buf = np.zeros((0,), np.int32)

    def _fill(self, n: int) -> np.ndarray:
        while self._buf.shape[0] < n:
            self._buf = np.concatenate([self._buf, next(self.source)])
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        n = self.batch * (self.seq + 1)
        block = self._fill(n).reshape(self.batch, self.seq + 1)
        return {"tokens": block[:, :-1].copy(), "labels": block[:, 1:].copy()}


def make_pipeline(cfg: ArchConfig, batch: int, seq: int, *, seed: int = 0,
                  rng: Optional[np.random.Generator] = None):
    """Batches for any arch (adds modality-stub arrays where required)."""
    rng = rng or np.random.default_rng(seed + 1)
    base = PackedBatcher(DocumentSource(cfg.vocab_size, seed), batch, seq)

    def gen():
        for b in base:
            if cfg.frontend == "audio":
                b["frames"] = rng.standard_normal(
                    (batch, cfg.encoder_seq_len, cfg.d_model)).astype(np.float32)
            if cfg.frontend == "vision":
                fd = cfg.frontend_dim or cfg.d_model
                b["patches"] = rng.standard_normal(
                    (batch, min(cfg.vision_patches, seq), fd)).astype(np.float32)
            yield b

    return gen()
