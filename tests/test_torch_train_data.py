"""The port's data pipeline and training batches, on the CPU.

``repro_torch.data.pipeline`` is a copy of the JAX package's numpy
pipeline: from one seed both yield the same batches, draw for draw
(tokens, labels, whisper's frames, qwen2-vl's patches).
``Model.make_train_batch`` draws from a ``torch.Generator`` (not draw for
draw with ``jax.random``): the JAX ``make_train_batch``'s keys, shapes,
dtypes and ranges, and ``train_batch_specs`` its shapes.
"""
import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import reduced as jax_reduced
from repro.data import pipeline as jax_pipeline
from repro.models.zoo import build_model as jax_build_model
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.configs import REGISTRY, reduced
from repro_torch.data import pipeline
from repro_torch.models.zoo import build_model

pytestmark = pytest.mark.jax              # the JAX pipeline is the reference

ARCHS = ["qwen3-4b", "mixtral-8x22b", "rwkv6-1.6b", "zamba2-2.7b", "whisper-large-v3",
         "qwen2-vl-7b"]


def test_pipeline_matches_jax_draw_for_draw():
    for arch, (B, S) in (("qwen3-4b", (4, 64)), ("whisper-large-v3", (2, 32)),
                         ("qwen2-vl-7b", (2, 32)), ("qwen2-vl-7b", (2, 4))):
        mine = pipeline.make_pipeline(reduced(REGISTRY[arch]), B, S, seed=3)
        theirs = jax_pipeline.make_pipeline(jax_reduced(JAX_REGISTRY[arch]), B, S, seed=3)
        for _ in range(4):
            a, b = next(mine), next(theirs)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (arch, k)
    assert (pipeline.BOS, pipeline.EOS) == (jax_pipeline.BOS, jax_pipeline.EOS)


def test_packing_shapes_and_labels():
    b = next(iter(pipeline.PackedBatcher(iter(pipeline.DocumentSource(512, seed=0)), 4, 64)))
    assert b["tokens"].shape == b["labels"].shape == (4, 64)
    assert b["tokens"].dtype == np.int32
    flat_t, flat_l = b["tokens"].reshape(-1), b["labels"].reshape(-1)
    assert (flat_t[1:64] == flat_l[0:63]).mean() > 0.9
    cfg = reduced(REGISTRY["qwen2-vl-7b"])
    assert next(pipeline.make_pipeline(cfg, 2, 32))["patches"].shape[0] == 2
    cfg = reduced(REGISTRY["whisper-large-v3"])
    assert next(pipeline.make_pipeline(cfg, 2, 32))["frames"].shape[1] == cfg.encoder_seq_len


def test_make_train_batch_matches_jax_shapes_dtypes_ranges():
    dtypes = {torch.int32: np.int32, torch.float32: np.float32}
    for arch in ARCHS:
        model = build_model(reduced(REGISTRY[arch]), "cpu")
        jmodel = jax_build_model(jax_reduced(JAX_REGISTRY[arch]))
        gen = torch.Generator().manual_seed(0)
        got = model.make_train_batch(gen, 3, 16)
        want = jmodel.make_train_batch(jax.random.PRNGKey(0), 3, 16)
        specs = model.train_batch_specs(3, 16)
        jspecs = jmodel.train_batch_specs(3, 16)
        assert sorted(got) == sorted(want) == sorted(specs) == sorted(jspecs), arch
        for k, t in got.items():
            assert tuple(t.shape) == want[k].shape == specs[k][0] == jspecs[k].shape, (arch, k)
            assert dtypes[t.dtype] == want[k].dtype, (arch, k)
            if t.dtype == torch.int32:
                assert 0 <= int(t.min()) and int(t.max()) < model.cfg.vocab_size
            else:
                assert abs(float(t.mean())) < 0.2 and 0.8 < float(t.std()) < 1.2
        again = model.make_train_batch(torch.Generator().manual_seed(0), 3, 16)
        assert all(torch.equal(again[k], got[k]) for k in got)
