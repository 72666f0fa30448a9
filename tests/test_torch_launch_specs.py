"""The port's dry-run entry API against the JAX package's: ``input_specs``
for every (arch x shape), and the shapes table's applicability rules.

``input_specs`` gives meta tensors (no storage); their shapes and dtypes
must equal the reference's ShapeDtypeStructs, each per-layer cache leaf
against the stacked one less its layer axis.
"""
import jax
import pytest

from repro.configs import ASSIGNED
from repro.launch import shapes as jshapes
from repro.launch import steps as jsteps
from tests._torch_mesh import pair_cache
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.launch import shapes
from repro_torch.launch.steps import input_specs

pytestmark = pytest.mark.jax              # the JAX package is the reference


def _same(t, j, stacked, where):
    assert isinstance(t, torch.Tensor) and t.device.type == "meta", where
    shape = tuple(j.shape)[1:] if stacked else tuple(j.shape)
    assert tuple(t.shape) == shape, (where, tuple(t.shape), shape)
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (where, t.dtype, j.dtype)


@pytest.mark.parametrize("kind", ["train", "serve"])
def test_input_specs_match_the_reference(kind):
    names = ["train_4k"] if kind == "train" else ["prefill_32k", "decode_32k", "long_500k"]
    n = 0
    for arch in ASSIGNED:
        for name in names:
            if not shapes.applicable(arch, name):
                continue
            with jax.enable_x64(False):
                want = jsteps.input_specs(arch, name)
            got = input_specs(arch, name)
            assert set(got) == set(want), (arch, name)
            if jshapes.SHAPES[name].kind == "train":
                for key in want:
                    _same(got[key], want[key], False, (arch, name, key))
                    n += 1
                continue
            batch = got.get("batch", {"token": got.get("token")})
            wbatch = want.get("batch", {"token": want.get("token")})
            for key in wbatch:
                _same(batch[key], wbatch[key], False, (arch, name, key))
            for path, t, j, stacked in pair_cache(got["cache"], want["cache"]):
                if isinstance(t, int):       # step, mrope_delta: host ints, () int32 in JAX
                    assert t == 0 and tuple(j.shape) == () and str(j.dtype) == "int32"
                else:
                    _same(t, j, stacked, (arch, name, path))
                n += 1
    assert n > 0


def test_shapes_table_and_applicability_equal_the_reference():
    assert {k: tuple(v.__dict__.values()) for k, v in shapes.SHAPES.items()} == \
        {k: tuple(v.__dict__.values()) for k, v in jshapes.SHAPES.items()}
    for arch in ASSIGNED:
        for name in shapes.SHAPES:
            assert shapes.applicable(arch, name) == jshapes.applicable(arch, name), (arch, name)
            assert shapes.skip_reason(arch, name) == jshapes.skip_reason(arch, name)
            got, want = shapes.effective_config(arch, name), jshapes.effective_config(arch, name)
            assert got.__dict__ == want.__dict__, (arch, name)
