"""Gradient accumulation on 4 gloo ranks of the CPU, a 2x2 ("data",
"model") mesh: the built train step cuts the global batch into contiguous
microbatches as the JAX package's ``make_train_step`` does
(``a.reshape((M, B // M) + ...)``), so on more than one data rank a
microbatch holds the same rows as in one process.  Where a loss term is
not a mean over rows (the MoE load-balance loss) the loss and every
gradient then equal the one-process step's on the batch as given, which
``tests/test_torch_steps.py`` holds to the JAX package's ``make_train_step``.

The ranks run in one subprocess (a process group cannot share the test
process); rank 0 also runs the one-process step and writes both to a file.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency

REPO = Path(__file__).resolve().parent.parent
B, S, M = 8, 32, 2
RANKS = '''
import datetime, socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

B, S, M = %(B)d, %(S)d, %(M)d


class GradsOut:
    """An optimizer that returns the gradients in place of the params."""

    def init(self, params):
        from repro_torch.training.optimizer import AdamW
        return AdamW().init(params)

    def update(self, grads, state, params):
        return grads, state


def whole(tree):
    from torch.distributed.tensor import DTensor
    from repro_torch.tree import tree_map
    return tree_map(lambda t: t.full_tensor() if isinstance(t, DTensor) else t, tree)


def run(rank, port, path):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.data.pipeline import make_pipeline
    from repro_torch.kernels.ops import register_mesh_rules
    from repro_torch.launch import steps
    from repro_torch.launch.shapes import InputShape
    from repro_torch.models.zoo import build_model
    from repro_torch.tree import tree_leaves, tree_paths
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=4, timeout=datetime.timedelta(seconds=60))
    register_mesh_rules()
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    out = {}

    # the microbatches' rows: row r of the batch holds r in every column
    rows = torch.arange(B, dtype=torch.int32)[:, None].expand(B, S).contiguous()
    st = steps.make_train_step("qwen3-4b", mesh, shape=InputShape("r", S, B, "train"),
                               cfg=reduced(REGISTRY["qwen3-4b"]), microbatches=M)
    placed = st.place(2, {"tokens": rows, "labels": rows})
    for m, mb in enumerate(steps._microbatches(placed, M)):
        out[f"rows{m}"] = whole(mb["tokens"])[:, 0].numpy()
        out[f"rows{m}_local{rank}"] = mb["tokens"].to_local()[:, 0].numpy()

    # reduced mixtral-8x22b, float32, M microbatches, on the batch as given
    cfg = reduced(REGISTRY["mixtral-8x22b"]).replace(dtype="float32")
    params = build_model(cfg, "cpu").init(0)
    batch = {k: torch.from_numpy(v) for k, v in next(make_pipeline(cfg, B, S, seed=0)).items()}
    st = steps.make_train_step("mixtral-8x22b", mesh, shape=InputShape("r", S, B, "train"),
                               cfg=cfg, remat=False, microbatches=M, opt=GradsOut())
    g, _, loss = whole(st.fn(*st.shard(params, GradsOut().init(params), batch)))
    if rank == 0:
        pg, _, ploss = st.fn(params, GradsOut().init(params), batch)
        out["loss"], out["plain_loss"] = float(loss), float(ploss)
        for name, a, b in zip(tree_paths(g), tree_leaves(g), tree_leaves(pg)):
            out["g" + name], out["plain_g" + name] = a.numpy(), b.numpy()
        np.savez(path, **out)
    else:
        np.savez(path + f".{rank}", **{k: v for k, v in out.items() if "_local" in k})
    dist.destroy_process_group()


if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(port, sys.argv[1]), nprocs=4)
''' % {"B": B, "S": S, "M": M}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("microbatch")
    path = str(tmp / "out.npz")
    script = tmp / "ranks.py"                      # spawned ranks import it by name
    script.write_text(RANKS)
    out = subprocess.run([sys.executable, str(script), path], capture_output=True, text=True,
                         cwd=REPO, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp), "TMPDIR": str(tmp)})
    assert out.returncode == 0, out.stderr[-4000:]
    d = dict(np.load(path))
    for r in (1, 2, 3):
        d.update(np.load(f"{path}.{r}.npz"))
    return d


def test_microbatches_are_the_global_batch_cut_contiguously(ranks):
    """Microbatch m is rows m·B/M .. (m+1)·B/M of the global batch, and on
    the 2x2 mesh each data rank holds its half of them (ranks 0, 1 on data
    coordinate 0; 2, 3 on 1), the model ranks alike."""
    n = B // M
    for m in range(M):
        want = np.arange(m * n, (m + 1) * n)
        assert np.array_equal(ranks[f"rows{m}"], want), (m, ranks[f"rows{m}"])
        for rank in range(4):
            half = want[(rank // 2) * n // 2:(rank // 2 + 1) * n // 2]
            assert np.array_equal(ranks[f"rows{m}_local{rank}"], half), (m, rank)


def test_moe_float32_accumulation_on_2x2_equals_one_process(ranks):
    """reduced mixtral-8x22b in float32, M = 2, on the batch as given: the
    loss within 1e-6 relative and every gradient leaf within 1e-4 of its
    max of the one-process step (the bounds of ``test_torch_mesh_ranks``)."""
    d = ranks
    assert abs(d["loss"] / d["plain_loss"] - 1) <= 1e-6, (d["loss"], d["plain_loss"])
    bad = {}
    names = [k[1:] for k in d if k.startswith("g")]
    assert names
    for name in names:
        a, b = d["g" + name].astype(np.float64), d["plain_g" + name].astype(np.float64)
        assert np.isfinite(a).all(), name
        err = np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-12)
        if err > 1e-4:
            bad[name] = err
    assert not bad, bad
