"""The port's step builders on 4 gloo ranks of the CPU, a 2x2 ("data",
"model") mesh, against the same steps on plain tensors in one process
(which ``tests/test_torch_steps.py`` holds equal to ``loop.make_step``,
the ``Model`` methods and the JAX package's ``make_train_step``).

On 2x2 every sharded path runs with real values: batch rows over data,
weights over data (fsdp) and model (tp), sequence-parallel residuals,
vocabulary-sharded logits, the attention backward per rank, MoE experts
per rank, a decode cache sharded over its slots (``kv_seq_shard`` at 2048
slots), int8 moments quantized per shard.

Both runs take the same batch: a microbatch is the global batch's
contiguous rows on the mesh as in one process (``steps._microbatches``),
which matters where a loss term is not a mean over rows (the MoE
load-balance loss).  The decode steps run the partial kernel on each
rank's slots and combine the ranks (``attention._decode_on_slot_shards``).

The ranks run in one subprocess for the four cases (a process group
cannot share the test process); rank 0 also runs the one-process
reference and writes both to a file.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency

REPO = Path(__file__).resolve().parent.parent
RANKS = '''
import datetime, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, S = 4, 32


class GradsOut:
    """Runs ``opt``'s update and returns the gradients in place of the params."""

    def __init__(self, opt):
        self.opt = opt

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        return grads, self.opt.update(grads, state, params)[1]


def whole(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def flat(prefix, tree):
    from repro_torch.tree import tree_leaves, tree_paths
    return {prefix + n: t.float().numpy() for n, t in zip(tree_paths(tree), tree_leaves(tree))}


def train(case, arch, mesh, out, *, dtype, M, opt, moe_ep=None):
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.zoo import build_model
    cfg = reduced(REGISTRY[arch]).replace(dtype=dtype)
    params = build_model(cfg, "cpu").init(0)
    batch = {k: torch.from_numpy(v) for k, v in next(make_pipeline(cfg, B, S, seed=0)).items()}
    build = lambda cfg: steps.make_train_step(
        arch, mesh, shape=InputShape("reduced", S, B, "train"), cfg=cfg, remat=True,
        microbatches=M, opt=GradsOut(opt), moe_ep=moe_ep)
    st = build(cfg)
    g, o, loss = whole(st.fn(*st.shard(params, opt.init(params), batch)))
    if dist.get_rank():
        return
    pg, po, ploss = st.fn(params, opt.init(params), batch)
    out.update({f"{case}/loss": float(loss), f"{case}/plain_loss": float(ploss)})
    out.update(flat(f"{case}/g", g))
    out.update(flat(f"{case}/plain_g", pg))
    out.update(flat(f"{case}/mu", o.mu))
    if dtype == "float32":
        out.update(flat(f"{case}/plain_mu", po.mu))
    else:
        # the float32 step the bf16 runs round, and the moments the
        # optimizer gives the mesh's own gradients in one process
        g32, _, loss32 = build(cfg.replace(dtype="float32")).fn(params, opt.init(params), batch)
        out[f"{case}/f32_loss"] = float(loss32)
        out.update(flat(f"{case}/f32_g", g32))
        out.update(flat(f"{case}/own_mu", opt.update(g, opt.init(params), params)[1].mu))


def serve(case, arch, mesh, out, max_len=2048):
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.zoo import build_model
    cfg = reduced(REGISTRY[arch])
    model = build_model(cfg, "cpu")
    params = model.init(0)
    prompt = torch.from_numpy(next(make_pipeline(cfg, B, S, seed=0))["tokens"])
    pre = steps.make_prefill_step(arch, mesh, shape=InputShape("r", max_len, B, "prefill"),
                                  cfg=cfg)
    dec = steps.make_decode_step(arch, mesh, shape=InputShape("r", max_len, B, "decode"),
                                 cfg=cfg)
    p, b, c = pre.shard(params, {"tokens": prompt},
                        model.init_cache(B, max_len, dtype=torch.float32))
    out[f"{case}/slots_sharded"] = np.array(
        any(getattr(pl, "dim", None) == 2 for pl in c["layers"][0].k.placements))
    logits, c = pre.fn(p, b, c)
    logits = whole(logits)
    toks = [logits.argmax(-1).to(torch.int32)[:, None]]
    # the decode steps' calls of the served and of the partial kernel
    from repro_torch.kernels import ops
    calls = dict.fromkeys(("decode_attention", "decode_attention_partial"), 0)
    kept = {name: getattr(ops, name) for name in calls}

    def counting(name):
        def call(*a, **kw):
            calls[name] += 1
            return kept[name](*a, **kw)
        return call
    for name in calls:
        setattr(ops, name, counting(name))
    try:
        for _ in range(3):
            nxt, c = dec.fn(p, dec.place(1, toks[-1]), c)
            toks.append(whole(nxt))
    finally:
        for name, fn in kept.items():
            setattr(ops, name, fn)
    out[f"{case}/decode_calls"] = np.array([calls["decode_attention"],
                                            calls["decode_attention_partial"], cfg.n_layers])
    c = whole(c)
    if dist.get_rank():
        return
    cache = model.init_cache(B, max_len, dtype=torch.float32)
    want, cache = model.prefill(params, {"tokens": prompt}, cache)
    wt = [want.argmax(-1).to(torch.int32)[:, None]]
    for _ in range(3):
        lg, cache = model.decode_step(params, wt[-1], cache)
        wt.append(lg[:, -1].argmax(-1).to(torch.int32)[:, None])
    out[f"{case}/toks"], out[f"{case}/plain_toks"] = torch.cat(toks, 1).numpy(), torch.cat(wt, 1).numpy()
    out[f"{case}/logits"], out[f"{case}/plain_logits"] = logits.numpy(), want.numpy()
    for i, (a, w) in enumerate(zip(c["layers"], cache["layers"])):
        for f in ("k", "v", "pos"):
            out[f"{case}/cache{i}.{f}"] = getattr(a, f).float().numpy()
            out[f"{case}/plain_cache{i}.{f}"] = getattr(w, f).float().numpy()


def run(rank, port, path):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.kernels.ops import register_mesh_rules
    from repro_torch.training.optimizer import AdamW
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4, timeout=datetime.timedelta(seconds=60))
    register_mesh_rules()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}
    cases = {
        "qwen3": lambda: train("qwen3", "qwen3-4b", mesh, out, dtype="float32", M=2,
                               opt=AdamW()),
        "serve": lambda: serve("serve", "qwen3-4b", mesh, out),
        "dbrx": lambda: train("dbrx", "dbrx-132b", mesh, out, dtype="float32", M=1,
                              opt=AdamW(), moe_ep=False),
        "mixtral": lambda: train("mixtral", "mixtral-8x22b", mesh, out, dtype="bfloat16",
                                 M=2, opt=AdamW(quant_min_size=1024)),
    }
    for case in cases.values():
        case()
    if rank == 0:
        np.savez(path, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(port, sys.argv[1]), nprocs=4)
'''


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    path = str(tmp / "out.npz")
    script = tmp / "ranks.py"                      # spawned ranks import it by name
    script.write_text(RANKS)
    out = subprocess.run([sys.executable, str(script), path], capture_output=True, text=True,
                         cwd=REPO, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp), "TMPDIR": str(tmp)})
    assert out.returncode == 0, out.stderr[-4000:]
    return np.load(path)


def leaf_errors(d, case, got, want):
    """{leaf: max|got - want| / max|want|} over the leaves under
    ``case/got`` against ``case/want``."""
    pre = f"{case}/{got}"
    out = {}
    for k in d.files:
        if k.startswith(pre + "."):
            a, b = d[k].astype(np.float64), d[f"{case}/{want}" + k[len(pre):]].astype(np.float64)
            assert a.shape == b.shape and np.isfinite(a).all(), k
            out[k[len(pre):]] = float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12))
    assert out, pre
    return out


def check_float32_train(d, case):
    """The loss within 1e-6 relative; every gradient leaf and every Adam
    first moment (after global-norm clipping, an all-reduce on the mesh)
    within 1e-4 of its max, as test_torch_steps.py holds M = 2 to M = 1."""
    assert abs(float(d[f"{case}/loss"]) / float(d[f"{case}/plain_loss"]) - 1) <= 1e-6
    for kind in ("g", "mu"):
        errs = leaf_errors(d, case, kind, f"plain_{kind}")
        bad = {k: e for k, e in errs.items() if e > 1e-4}
        assert not bad, (kind, bad)


def test_dense_train_step_with_accumulation_and_remat_on_2x2(ranks):
    """reduced qwen3-4b, M = 2, remat on."""
    check_float32_train(ranks, "qwen3")


def test_prefill_and_decode_steps_on_2x2(ranks):
    """reduced qwen3-4b served from a 2048-slot cache sharded over its slots
    and batch rows over data: the prefill's logits (1e-5 of max|logit|),
    four greedy tokens, and every layer's cache after three decode steps
    equal ``Model.prefill`` / ``decode_step``'s.  Each decode step runs the
    partial kernel once a layer on each rank's slots, and the served
    kernel never."""
    d = ranks
    assert bool(d["serve/slots_sharded"])
    served, partial, layers = d["serve/decode_calls"].tolist()
    assert (served, partial) == (0, 3 * layers), (served, partial, layers)
    assert np.array_equal(d["serve/toks"], d["serve/plain_toks"])
    lg, want = d["serve/logits"], d["serve/plain_logits"]
    assert np.max(np.abs(lg - want)) <= 1e-5 * np.max(np.abs(want))
    for k in d.files:
        if k.startswith("serve/cache"):
            w = d["serve/plain_" + k[len("serve/"):]]
            assert np.max(np.abs(d[k] - w)) <= 1e-5 * (np.max(np.abs(w)) + 1e-12), k


def test_moe_train_step_without_expert_parallelism_on_2x2(ranks):
    """reduced dbrx-132b (4 experts over a 2-way data axis, so ``apply_moe``
    and not ``apply_moe_ep``): the experts run per rank over its rows and
    its tp slice of F, their gradients partial over data and tp."""
    check_float32_train(ranks, "dbrx")


def test_bf16_accumulation_and_int8_moments_on_2x2(ranks):
    """reduced mixtral-8x22b in bfloat16 with ``TRAIN_ACC_DTYPE``'s bf16
    accumulation (M = 2) and int8 moments.  bf16 rounds both runs: against
    the float32 step, the mesh's loss and each gradient leaf are within
    twice the one-process bf16 run's error (and within 1e-4 where that is
    smaller).  The moments, quantized shard by shard, equal what the
    optimizer in one process makes of the mesh's own gradients: int8 codes
    within one step, scales within 1e-6 of their max."""
    d, case = ranks, "mixtral"
    f32 = float(d[f"{case}/f32_loss"])
    err = lambda k: abs(float(d[f"{case}/{k}"]) - f32)
    assert np.isfinite(float(d[f"{case}/loss"]))
    assert err("loss") <= max(2 * err("plain_loss"), 1e-4 * abs(f32))
    mesh, plain = leaf_errors(d, case, "g", "f32_g"), leaf_errors(d, case, "plain_g", "f32_g")
    bad = {k: (e, plain[k]) for k, e in mesh.items() if e > max(2 * plain[k], 1e-4)}
    assert not bad, bad
    q = [k for k in d.files if k.startswith(f"{case}/mu.") and k.endswith(".q")]
    assert q, "no moment was quantized"
    for k in q:
        want = d[f"{case}/own_mu" + k[len(f"{case}/mu"):]]
        assert np.max(np.abs(d[k] - want)) <= 1, k
        s, ws = d[k[:-2] + ".scale"], d[f"{case}/own_mu" + k[len(f"{case}/mu"):-2] + ".scale"]
        assert np.max(np.abs(s - ws)) <= 1e-6 * np.max(np.abs(ws)), k
