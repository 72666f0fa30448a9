"""The served prefill replayed as one CUDA graph.

``Model.prefill`` hands each call to its model's ``PrefillGraphs``.  A
call is eligible when it runs on a card, with autograd off (inference mode
or no-grad) and without sharding hints (the mesh path stays eager); its
key is what the graph depends on: the batch's names, shapes and dtypes,
inference mode, and the identity of the parameter tree and of the cache's
tensors.

- The first call of a key runs ``transformer.prefill`` eagerly on a
  capture stream of its own and returns that result; then the same call
  is captured.  The eager run warms what the pass makes once a (card,
  stream): ``kernels/gemm.py``'s split-K scratch, plans and calls, and
  cuBLAS's workspace, so nothing grows inside the capture (a workspace
  grown there would free the block an earlier captured node points at).
  ``torch.cuda.graph`` synchronises on entry: capture belongs in set-up,
  the engine's first pass.  A capture that raises leaves the key eager.
- A later call copies its batch into the graph's static inputs, replays
  it on the current stream under the span ``model.graph.replay``, sets
  the cache's host fields (``transformer.prefill_host_fields``) and
  returns a clone of the static logits, so no later pass overwrites a
  result already handed out.  The cache's tensors are written in place,
  as the eager pass writes them.
- The host counts a pass's enqueue moves (``ops.launch_counts()``,
  ``gemm.declined``, ``rope.position_table.built``, each MoE layer's
  ``moe.tallies()``) are read around the capture, put back, and advanced
  by the capture's amounts on every replay: each still counts what a
  pass launched, which the graph launches.  The device counts of the MoE
  layers are tensors the graph adds to in place.

``spans.graph_counts()`` counts each call's outcome: ``captured``,
``replayed`` or ``eager``.  At most ``MAX_GRAPHS`` keys are kept a model,
the least recently used dropped first.
"""
from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import gemm, ops
from repro_torch.models import moe, rope
from repro_torch.models import transformer as T
from repro_torch.profiling import spans
from repro_torch.tree import tree_leaves

MAX_GRAPHS = 4


class CudaGraph:
    """One prefill on the card: its eager first run and its capture on a
    stream of its own, its replays on the caller's stream."""
    device_type = "cuda"

    def __init__(self, device: torch.device, stream=None):
        self.stream = stream or torch.cuda.Stream(device)
        self.graph = torch.cuda.CUDAGraph()

    def warm(self, fn):
        """fn() run eagerly on the capture stream, ordered after and before
        the caller's stream's work."""
        here = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            out = fn()
        here.wait_stream(self.stream)
        return out

    def capture(self, fn):
        """fn() captured; the caller's stream is current again after it, also
        where the capture raised (``torch.cuda.graph``'s exit leaves the
        capture stream current when ending the capture raises)."""
        here = torch.cuda.current_stream(self.stream.device)
        try:
            with torch.cuda.graph(self.graph, stream=self.stream):
                return fn()
        finally:
            torch.cuda.set_stream(here)

    def replay(self):
        self.graph.replay()


Graph = CudaGraph      # the tests put a fake in its place to run the dispatch on the CPU


@dataclasses.dataclass
class _Entry:
    graph: Optional[Any]            # None: the key stays eager (its capture failed)
    inputs: Dict[str, torch.Tensor]  # the static batch
    logits: Optional[torch.Tensor]  # the static output
    advance: List[Tuple[Any, str, int]]  # (holder, attribute, amount) a replay adds
    held: tuple                     # what the key's identities name, kept alive


def _counters() -> List[Tuple[Any, str]]:
    """Each count the host moves while it enqueues a prefill, as (holder,
    attribute)."""
    return ([(fn, "launches") for fn in ops.KERNELS.values()]
            + [(gemm.gemm, "declined"), (rope.position_table, "built")]
            + [(t, "host") for t in moe.tallies()])


def _cache_tensors(cache) -> list:
    """The cache's tensors (its per-layer lists of caches and K/V pairs),
    without walking the whole tree: the key reads them on every call."""
    return [t for v in cache.values() if isinstance(v, list)
            for c in v for t in (c if isinstance(c, tuple) else vars(c).values())
            if isinstance(t, torch.Tensor)]


def eligible(device: torch.device, batch, shard) -> bool:
    """A call a graph may serve: on ``Graph``'s device type, autograd off,
    no sharding hints, the batch on ``device``."""
    return (device.type == Graph.device_type and shard is T.NO_HINTS
            and not torch.is_grad_enabled() and all(t.device == device for t in batch.values()))


def key(params, batch, cache) -> tuple:
    """What a captured graph depends on: inference mode, the batch's names,
    shapes and dtypes, the parameter tree's and the cache tensors'
    identities."""
    return (torch.is_inference_mode_enabled(),
            tuple((name, tuple(t.shape), t.dtype) for name, t in batch.items()),
            id(params), tuple(map(id, _cache_tensors(cache))))


class PrefillGraphs:
    """A model's captured prefills, by ``key``."""

    def __init__(self):
        self._entries: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
        self._streams: list = []      # capture streams of dropped graphs, for the next

    def prefill(self, cfg, device, params, batch, cache, shard):
        """``transformer.prefill(params, cfg, batch, cache, shard=shard)``,
        replayed from a graph where the call is ``eligible``."""
        if not eligible(device, batch, shard):
            spans.count_graph("eager")
            return T.prefill(params, cfg, batch, cache, shard=shard)
        k = key(params, batch, cache)
        entry = self._entries.get(k)
        if entry is None:
            return self._first(k, cfg, device, params, batch, cache)
        self._entries.move_to_end(k)
        if entry.graph is None:
            spans.count_graph("eager")
            return T.prefill(params, cfg, batch, cache)
        for name, t in batch.items():
            entry.inputs[name].copy_(t)
        with spans.span("model.graph.replay"):
            entry.graph.replay()
        for holder, attr, n in entry.advance:
            setattr(holder, attr, getattr(holder, attr) + n)
        cache.update(T.prefill_host_fields(cfg, batch))
        spans.count_graph("replayed")
        return entry.logits.clone(), cache

    def _first(self, k, cfg, device, params, batch, cache):
        """The key's first call: eager on the capture stream, then captured."""
        while len(self._entries) >= MAX_GRAPHS:
            _, old = self._entries.popitem(last=False)
            if old.graph is not None:       # its pool is freed: no replay may still run
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                self._streams.append(old.graph.stream)
        inputs = {name: t.clone() for name, t in batch.items()}
        graph = Graph(device, self._streams.pop() if self._streams else None)
        run = lambda: T.prefill(params, cfg, inputs, cache)
        out = graph.warm(run)
        counters = _counters()
        before = [getattr(h, a) for h, a in counters]
        try:
            logits, _ = graph.capture(run)
        except Exception as e:   # anything the pass does that a capture refuses
            warnings.warn(f"{cfg.name}: the prefill was not captured and runs eagerly: {e!r}",
                          RuntimeWarning)
            self._streams.append(graph.stream)
            graph, logits, inputs = None, None, {}
        after = [getattr(h, a) for h, a in counters]
        for (h, a), n in zip(counters, before):
            setattr(h, a, n)
        advance = [(h, a, m - n) for (h, a), n, m in zip(counters, before, after) if m != n]
        held = (params, tree_leaves(params), _cache_tensors(cache))
        self._entries[k] = _Entry(graph, inputs, logits, advance, held)
        spans.count_graph("eager" if graph is None else "captured")
        return out
