"""RoPE's rotation table, on the CPU: built on the device from the Python
theta (no host tensor, so no blocking copy to a card), equal bit for bit to
the per-call formula it replaces, built once a prefill and once a layer a
decode step, and no host round trip inside a served pass.

Each test file of the port holds at most four tests, as
``tests/_torch_parity.py`` explains."""
import pytest
import torch

from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import rope
from repro_torch.models.zoo import build_model

B, S, LAYERS = 2, 12, 3


def formula_freqs(head_dim, theta):
    """The per-call formula the table replaces: theta as a host tensor."""
    dim = torch.arange(head_dim // 2, dtype=torch.float32)
    return torch.tensor(theta, dtype=torch.float32) ** (-2.0 * dim / head_dim)


def formula_rotate(x, coords, head_dim, theta):
    ang = coords * formula_freqs(head_dim, theta)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf, h = x.float(), head_dim // 2
    return torch.cat([xf[..., :h] * cos - xf[..., h:] * sin,
                      xf[..., h:] * cos + xf[..., :h] * sin], dim=-1).to(x.dtype)


@pytest.mark.parametrize("head_dim,theta,sections", [
    (128, 5e6, None), (128, 1e6, None), (64, 1e4, None), (80, 1e6, None),
    (128, 1e6, (16, 24, 24))])                          # qwen2-vl-7b's M-RoPE
def test_table_equals_the_per_call_formula(head_dim, theta, sections):
    g = torch.Generator().manual_seed(head_dim)
    x = torch.randn((B, 40, 4, head_dim), generator=g)
    assert torch.equal(rope.rope_freqs(head_dim, theta), formula_freqs(head_dim, theta))
    if sections is None:
        pos = torch.randint(0, 4096, (B, 40), generator=g, dtype=torch.int32)
        got = rope.apply_rope(x, pos, theta)
        coords = pos[..., None].float()
    else:
        pos = torch.randint(0, 64, (B, 40, 3), generator=g, dtype=torch.int32)
        got = rope.apply_m_rope(x, pos, theta, sections)
        sec = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
        coords = pos.float()[..., sec]
    want = formula_rotate(x, coords, head_dim, theta)
    assert torch.equal(got, want)
    cos, sin = rope.position_table(pos, head_dim, theta, sections)
    assert cos.shape == sin.shape == (B, 40, 1, head_dim // 2)
    assert torch.equal(rope.rotate(x, (cos, sin)), want)


def served(arch):
    cfg = reduced(REGISTRY[arch]).replace(n_layers=LAYERS)
    if arch == "qwen1.5-4b":
        cfg = cfg.replace(rope_theta=5e6)        # the published config.json's theta
    model = build_model(cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(3, cfg.vocab_size, (B, S), generator=g,
                                     dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["patches"] = torch.randn((B, cfg.vision_patches, cfg.frontend_dim), generator=g)
    return cfg, model, model.init(0), batch


def serve(model, params, batch, decode_steps=1):
    """A prefill and ``decode_steps`` decode steps -> the tables each built."""
    built = []
    with torch.inference_mode():
        cache = model.init_cache(B, S + 4, dtype=torch.float32)
        n = rope.position_table.built
        logits, cache = model.prefill(params, batch, cache)
        built.append(rope.position_table.built - n)
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        for _ in range(decode_steps):
            n = rope.position_table.built
            logits, cache = model.decode_step(params, tok, cache)
            built.append(rope.position_table.built - n)
            tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
    return built


@pytest.mark.parametrize("arch,prefill,decode", [
    ("qwen1.5-4b", 1, LAYERS), ("qwen2-vl-7b", 1, LAYERS),
    ("rwkv6-1.6b", 0, 0)])                               # no rotation: no table
def test_one_table_a_prefill_and_one_a_layer_a_decode_step(arch, prefill, decode):
    cfg, model, params, batch = served(arch)
    assert serve(model, params, batch, decode_steps=2) == [prefill, decode, decode]


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "qwen2-vl-7b"])
def test_no_host_round_trip_inside_a_served_pass(arch, monkeypatch):
    """``torch.tensor`` (a host value copied to the device, blocking on a
    card), ``item``, ``tolist`` and ``cpu`` are never called inside
    ``Model.prefill`` or ``decode_step``."""
    cfg, model, params, batch = served(arch)
    calls = []

    def recorded(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    monkeypatch.setattr(torch, "tensor", recorded("torch.tensor", torch.tensor))
    for name in ("item", "tolist", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, recorded(name, getattr(torch.Tensor, name)))
    torch.tensor(0.0).item()                             # the recorder records
    assert calls == ["torch.tensor", "item"]
    calls.clear()
    assert serve(model, params, batch, decode_steps=2) == [1, LAYERS, LAYERS]
    assert calls == []
