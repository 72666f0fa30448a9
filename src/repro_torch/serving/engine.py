"""PyTorch serving engine (Triton-process analogue) on one GPU.

Counterpart of the JAX package's ``serving/engine.py`` with the same
batching and padding: requests queue up; each serving pass takes up to
``batch_size`` of them, zero-pads every prompt to ``prompt_len``, runs one
prefill (through the flash-attention or scan kernels) and
``decode_tokens - 1`` greedy decode steps, and returns ``decode_tokens``
tokens per request.  whisper's and qwen2-vl's frontends are stubs, as in
the JAX engine: every prefill gets zero ``frames`` (B, Se, d) or
``patches`` (B, min(vision_patches, prompt_len), frontend_dim).  Latency
runs from a request's arrival to the moment its output tokens reach the
host.

Each pass appends one record to ``profiling.spans.passes()``, the
process's bounded per-pass log: five ``time.time_ns()`` stamps that split
the pass into ``engine.take``, ``engine.dispatch``, ``engine.fetch`` and
``engine.complete`` (the phases ``profiling/spans.py`` defines), the rows,
the batch, the queue depth and the oldest request's arrival.  While a
profiler records, the phases are profiler spans too.
"""
from __future__ import annotations

import dataclasses
import itertools
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.zoo import Model, build_model
from repro_torch.profiling import spans

LATENCY_WINDOW = 4096     # latencies kept: p99_ms's default window reads the newest 200

_ENGINE_IDS = itertools.count()


@dataclasses.dataclass
class Request:
    rid: int
    tokens: np.ndarray            # (prompt_len,)
    arrival_s: float
    extras: Optional[Dict] = None


@dataclasses.dataclass
class Completion:
    rid: int
    tokens: np.ndarray
    latency_ms: float


def frontend_shapes(cfg: ArchConfig, batch: int, prompt_len: int) -> Dict[str, tuple]:
    """Shapes of the frontend stubs' inputs: frames (B, Se, d_model) for an
    audio model, patches (B, min(vision_patches, S), frontend_dim) for a
    vision one; {} for a text model."""
    shapes = {}
    if cfg.frontend == "audio":
        shapes["frames"] = (batch, cfg.encoder_seq_len, cfg.d_model)
    if cfg.frontend == "vision":
        shapes["patches"] = (batch, min(cfg.vision_patches, prompt_len),
                             cfg.frontend_dim or cfg.d_model)
    return shapes


class ServingEngine:
    """``device=None`` serves on cuda:0 and raises without CUDA; pass
    ``device="cpu"`` for the plain path.  ``params`` (e.g. from
    ``convert.params_from_jax``) replaces the seeded random weights."""

    def __init__(self, cfg: ArchConfig, *, batch_size: int, prompt_len: int,
                 decode_tokens: int = 4, seed: int = 0, params=None,
                 device=None):
        self.cfg = cfg
        self.model: Model = build_model(cfg, device)
        self.device = self.model.device
        self.batch_size = batch_size
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        self.params = params if params is not None else self.model.init(seed)
        self.extras = self._dummy_extras()
        self.queue: Deque[Request] = deque()
        self.latencies: Deque[float] = deque(maxlen=LATENCY_WINDOW)
        self.engine_id = next(_ENGINE_IDS)
        self._fetched_ns = 0          # _serve's stamp between dispatch and fetch
        # One cache per engine, in float32 as in the JAX engine.  Each pass
        # starts where the JAX engine's fresh cache starts: reset_cache zeros
        # the recurrent states, and prefill overwrites every KV slot and the
        # write position.
        self._cache = self.model.init_cache(
            batch_size, prompt_len + decode_tokens + 8, dtype=torch.float32)
        # warm-up (and first-use kernel build) so latencies are steady-state
        self._serve(np.zeros((batch_size, prompt_len), np.int32))

    @torch.inference_mode()
    def _serve(self, tokens: np.ndarray) -> np.ndarray:
        """One pass: every launch (``engine.dispatch``), then the wait for
        the device and the copy back (``engine.fetch``)."""
        with spans.span("engine.dispatch"):
            toks = torch.from_numpy(tokens).to(self.device)
            cache = self.model.reset_cache(self._cache)
            logits, cache = self.model.prefill(self.params, {"tokens": toks, **self.extras},
                                               cache)
            tok = logits.argmax(-1).to(torch.int32)[:, None]
            outs = [tok]
            for _ in range(self.decode_tokens - 1):
                lg, cache = self.model.decode_step(self.params, tok, cache)
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                outs.append(tok)
            out = torch.cat(outs, dim=1)
        self._fetched_ns = time.time_ns()
        with spans.span("engine.fetch"):
            return out.cpu().numpy()

    def _dummy_extras(self) -> Dict[str, torch.Tensor]:
        """The frontend stubs' inputs, zeros made once on the engine's device."""
        return {k: torch.zeros(shape, dtype=torch.float32, device=self.device)
                for k, shape in frontend_shapes(self.cfg, self.batch_size,
                                                self.prompt_len).items()}

    def submit(self, req: Request):
        self.queue.append(req)

    def pump(self) -> List[Completion]:
        """Serve one batch if any requests are queued."""
        if not self.queue:
            return []
        t_start = time.time_ns()
        queued = len(self.queue)
        with spans.span("engine.take"):
            take = [self.queue.popleft() for _ in range(min(self.batch_size, queued))]
            B, S = self.batch_size, self.prompt_len
            toks = np.zeros((B, S), np.int32)
            for i, r in enumerate(take):
                t = r.tokens[:S]
                toks[i, :len(t)] = t
        t_taken = self._fetched_ns = time.time_ns()
        out = self._serve(toks)          # returns after the copy to the host
        t_fetched = time.time_ns()
        done = t_fetched / 1e9
        with spans.span("engine.complete"):
            comps = []
            for i, r in enumerate(take):
                lat = (done - r.arrival_s) * 1000.0
                self.latencies.append(lat)
                comps.append(Completion(rid=r.rid, tokens=out[i], latency_ms=lat))
        # a _serve that never stamped the end of its dispatch (one replaced
        # without calling this one) leaves its phases unknown: no record
        if t_taken < self._fetched_ns <= t_fetched:
            spans.record(spans.PassRecord(
                self.engine_id, self.device.type, len(take), B, queued,
                min(r.arrival_s for r in take),
                (t_start, t_taken, self._fetched_ns, t_fetched, time.time_ns())))
        return comps

    def p99_ms(self, window: int = 200) -> float:
        if not self.latencies:
            return 0.0
        return float(np.percentile(list(self.latencies)[-window:], 99))
