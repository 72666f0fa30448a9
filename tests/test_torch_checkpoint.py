"""The port's checkpoints (``training/checkpoint.py``): the JAX package's
contract without msgpack, on the CPU.

A round trip of a tree with a bfloat16 leaf, an int32 step and an
``AdamWState`` with ``QuantState`` moments (bit for bit, dtypes and
structure kept, onto the template's device); retention of the newest
``keep``; a stray ``.tmp`` directory ignored; the reference's own
checkpoint test, mirrored.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.optimizer import AdamW, AdamWState, QuantState  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402


def test_roundtrip_keeps_dtypes_structure_and_quant_state(tmp_path):
    params = {"w": torch.randn(4, 512), "b": {"c": torch.ones(4, dtype=torch.bfloat16) / 3},
              "blocks": [{"s": torch.arange(3.0)}, {"s": torch.arange(3.0) + 1}]}
    opt = AdamW(quant_min_size=16)
    state = opt.init(params)
    params, state = opt.update(params, state, params)
    tree = (params, state)
    ckpt.save(str(tmp_path), 5, tree)
    like = (tree_map(torch.zeros_like, params), opt.init(params))
    (got_p, got_s), step = ckpt.restore_latest(str(tmp_path), like)
    assert step == 5
    assert isinstance(got_s, AdamWState) and isinstance(got_s.mu["w"], QuantState)
    assert isinstance(got_p["blocks"], list) and got_p["b"]["c"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves((got_p, got_s)), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert got_s.mu["w"].q.dtype == torch.int8 and int(got_s.step) == 1
    meta = json.load(open(tmp_path / "step_00000005" / "meta.json"))
    assert meta["step"] == 5 and meta["n_leaves"] == len(tree_leaves(tree))


def test_retention_and_unfinished_tmp_ignored(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.zeros(2)}
    assert ckpt.latest_step(d) is None and ckpt.restore_latest(d, tree) is None
    for step in (10, 20, 30, 40):
        ckpt.save(d, step, {"a": torch.full((2,), float(step))})
    assert sorted(os.listdir(d)) == ["step_00000020", "step_00000030", "step_00000040"]
    os.makedirs(os.path.join(d, "step_00000050.tmp"))      # a save cut short
    assert ckpt.latest_step(d) == 40
    got, step = ckpt.restore_latest(d, tree)
    assert step == 40 and torch.equal(got["a"], torch.full((2,), 40.0))
    with pytest.raises(ValueError):
        ckpt.restore(d, 40, {"a": torch.zeros(2), "b": torch.zeros(1)})


def test_checkpoint_roundtrip_as_the_reference():
    import tempfile
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32)}
    with tempfile.TemporaryDirectory() as d:
        ckpt.save(d, 10, tree)
        ckpt.save(d, 20, {"a": tree["a"] * 2, "b": {"c": tree["b"]["c"] * 2},
                          "step": tree["step"] * 2})
        restored, step = ckpt.restore_latest(d, tree)
        assert step == 20
        assert torch.equal(restored["a"], 2 * tree["a"])
        assert restored["b"]["c"].dtype == torch.bfloat16
