"""The port's dry run (``launch/dryrun.py``): ``run_one`` on reduced
configs over a fake 2x2 mesh, with the ops it counted saved as
``--save-hlo-dir`` saves them, and ``launch.train --dry-run`` on the full
qwen3-4b over the fake 16x16 mesh.

A fake process group cannot share the test process with another group,
so each runs in a subprocess; the records come back as JSON.
"""
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")      # the port's optional dependency
from repro_torch.configs import REGISTRY, reduced  # noqa: E402
from repro_torch.distributed import sharding as sh  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.tree import tree_map  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
B, S = 8, 64
MESH = {"data": 2, "model": 2}
RUN = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import REGISTRY, reduced
from repro_torch.kernels.ops import register_mesh_rules
from repro_torch.launch.dryrun import run_one
from repro_torch.launch.shapes import InputShape

dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
register_mesh_rules()
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
shape = InputShape("reduced", %(S)d, %(B)d, "train")
out = {}
out["qwen3-4b"] = run_one("qwen3-4b", "train_4k", mesh, shape=shape,
                          cfg=reduced(REGISTRY["qwen3-4b"]), save_ops=sys.argv[1] + "/qwen3-4b.ops")
# two experts on the 2-way data axis: the expert-parallel layer, two microbatches
out["dbrx-132b"] = run_one("dbrx-132b", "train_4k", mesh, shape=shape, microbatches=2,
                           cfg=reduced(REGISTRY["dbrx-132b"]).replace(n_experts=2, top_k=1),
                           save_ops=sys.argv[1] + "/dbrx-132b.ops")
print("RECORDS " + json.dumps(out))
""" % {"S": S, "B": B}


def _env(tmp):
    return {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin", "HOME": str(tmp),
            "TMPDIR": str(tmp)}


@pytest.fixture(scope="module")
def dryrun_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("dryrun")


@pytest.fixture(scope="module")
def records(dryrun_dir):
    tmp = dryrun_dir
    out = subprocess.run([sys.executable, "-c", RUN, str(tmp)], capture_output=True,
                         text=True, cwd=REPO, timeout=600, env=_env(tmp))
    assert out.returncode == 0, out.stderr[-3000:]
    line = next(l for l in out.stdout.splitlines() if l.startswith("RECORDS "))
    return json.loads(line[len("RECORDS "):])


def test_run_one_on_a_fake_mesh(records):
    """Both records are "ok", with the reference's fields, the expert
    layer's all-to-all among the collectives of the expert-parallel one."""
    for arch, rec in records.items():
        assert rec["status"] == "ok" and rec["mesh"] == "2x2", rec
        assert rec["mesh_device"] == ("cuda" if torch.cuda.is_available() else "cpu"), rec
        assert rec["torch"] == torch.__version__, rec
        assert rec["flops_per_dev"] > 0 and rec["hbm_bytes_per_dev"] > 0, rec
        assert rec["temp_bytes_per_dev"] > 0 and rec["collective_bytes_per_dev"] > 0, rec
        assert rec["dominant"] in ("compute", "memory", "collective")
        assert rec["fits_hbm"] is True
        for term, rate in (("compute_s", 989e12), ("memory_s", 3.35e12)):
            key = {"compute_s": "flops_per_dev", "memory_s": "hbm_bytes_per_dev"}[term]
            assert rec[term] == pytest.approx(rec[key] / rate)
    assert records["dbrx-132b"]["per_collective"].get("all-to-all", 0) > 0


def test_arg_bytes_are_the_local_shards(records):
    """arg_bytes_per_dev of the qwen3-4b record equals the bytes of rank
    0's shards computed here from the resolved specs: float32 params and
    both Adam moments, the step counter, and the int32 batch over data."""
    cfg = reduced(REGISTRY["qwen3-4b"])
    abstract = T.abstract_params(cfg, torch.float32)
    specs = sh.resolve_tree(T.param_specs(cfg), abstract, MESH)
    local = []
    tree_map(lambda a, s: local.append(
        math.prod(sh.local_shape(a.shape, s, MESH)) * a.element_size()), abstract, specs)
    batch = 2 * (B // MESH["data"]) * S * 4              # tokens and labels
    assert records["qwen3-4b"]["arg_bytes_per_dev"] == 3 * sum(local) + 4 + batch


def test_saved_ops_sum_to_the_record(records, dryrun_dir):
    """The saved ops (one JSON line each) are the program the record was
    counted from: their flops, bytes and ring bytes sum to the record's
    ``flops_per_dev``, ``hbm_bytes_per_dev`` and collective term, one line
    per counted op, each collective naming its kind and group size."""
    for arch, rec in records.items():
        ops = [json.loads(line) for line in (dryrun_dir / f"{arch}.ops").open()]
        assert len(ops) == rec["ops_per_dev"], arch
        assert sum(r["flops"] for r in ops) == pytest.approx(rec["flops_per_dev"], rel=1e-12)
        assert sum(r["bytes"] for r in ops) == pytest.approx(rec["hbm_bytes_per_dev"], rel=1e-12)
        ring = sum(r.get("ring_bytes", 0.0) for r in ops)
        assert ring == pytest.approx(rec["collective_bytes_per_dev"], rel=1e-12)
        assert ring / 450e9 == pytest.approx(rec["collective_s"], rel=1e-12)
        coll = [r for r in ops if "collective" in r]
        assert coll and all(r["group"] == 2 for r in coll), arch
        kinds = {r["collective"] for r in coll}
        assert kinds == {k for k, v in rec["per_collective"].items() if v > 0}, arch


def test_train_launcher_dry_run(tmp_path):
    """``launch.train --dry-run --arch qwen3-4b`` runs the full config's
    train_4k step on the fake 16x16 mesh, exits 0 and prints its record."""
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", "--dry-run",
                          "--arch", "qwen3-4b"], capture_output=True, text=True, cwd=REPO,
                         timeout=600, env=_env(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["arch"] == "qwen3-4b" and rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["model_flops_global"] == pytest.approx(
        6.0 * REGISTRY["qwen3-4b"].n_active_params() * 256 * 4096)
