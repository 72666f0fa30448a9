"""Shared set-up of the mesh layer's parity tests (tests/test_torch_sharding.py,
tests/test_torch_launch_specs.py): the port's per-layer trees paired leaf
for leaf with the JAX package's stacked ones."""
import dataclasses
import types

from jax.sharding import PartitionSpec


def fake_mesh(shape):
    """A mesh the resolvers of both packages accept: only its axis sizes."""
    return types.SimpleNamespace(shape=dict(shape))


MESHES = {"1x1": {"data": 1, "model": 1}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


def entries(spec):
    return tuple(spec)


def pair_params(port, ref, path=""):
    """(path, port leaf, reference leaf, stacked) over a parameter tree:
    the port's ``blocks`` / ``encoder`` lists against the reference's
    stacked dicts (the reference leaf then has a leading layer axis)."""
    for key, val in port.items():
        if isinstance(val, list):
            for i, layer in enumerate(val):
                yield from _pair(layer, ref[key], f"{path}.{key}[{i}]", True)
        else:
            yield from _pair(val, ref[key], f"{path}.{key}", False)


def _pair(port, ref, path, stacked):
    if isinstance(port, dict):
        for k, v in port.items():
            yield from _pair(v, ref[k], f"{path}.{k}", stacked)
    else:
        yield path, port, ref, stacked


def pair_cache(port, ref):
    """(path, port leaf, reference leaf, stacked) over a decode cache: the
    port's per-layer ``layers`` / ``shared`` entries and ``cross`` (k, v)
    pairs against the reference's stacked caches and ``cross_k`` /
    ``cross_v``; ``step`` / ``mrope_delta`` as they are."""
    for key, val in port.items():
        if key == "cross":
            for i, (k, v) in enumerate(val):
                yield f"cross[{i}].k", k, ref["cross_k"], True
                yield f"cross[{i}].v", v, ref["cross_v"], True
        elif isinstance(val, list):
            for i, entry in enumerate(val):
                for f in dataclasses.fields(entry):
                    if f.name == "window":
                        continue
                    yield (f"{key}[{i}].{f.name}", getattr(entry, f.name),
                           getattr(ref[key], f.name), True)
        else:
            yield key, val, ref[key], False


def spec_tuple(spec, stacked):
    """A reference spec's entries, the layer axis's dropped when stacked."""
    assert isinstance(spec, PartitionSpec), spec
    t = tuple(spec)
    return t[1:] if stacked else t
