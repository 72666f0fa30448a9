"""The port's expert-parallel MoE layer (``apply_moe_ep``) on 8 gloo ranks
of the CPU, 4-way data (one expert a rank) x 2-way model, against the
port's and the JAX package's ``apply_moe`` in the dropless regime.

The reference test's configuration (tests/test_extensions.py): reduced
dbrx-132b with 4 experts, top-2 and capacity factor 8.0.  The ranks run
in a subprocess (a process group cannot share the test process), which
reads the weights and input from a file and writes rank 0's whole output.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.configs import reduced as jax_reduced
from repro.models import moe as JM
from tests._torch_parity import jax_32bit, torch  # noqa: F401
from repro_torch.configs import REGISTRY, reduced
from repro_torch.models import moe as M

pytestmark = pytest.mark.jax              # the JAX package is one reference

REPO = Path(__file__).resolve().parent.parent
RANKS = """
import socket, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def run(rank, port, path):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import moe as M
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=8)
    mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data", "model"))
    cfg = reduced(REGISTRY["dbrx-132b"]).replace(n_experts=4, top_k=2, capacity_factor=8.0)
    data = np.load(path)
    p = {k: torch.from_numpy(data[k]) for k in ("router", "w_gate", "w_up", "w_down")}
    y, aux = M.apply_moe_ep(p, torch.from_numpy(data["x"]), cfg, mesh=mesh)
    y, aux = y.full_tensor(), aux.full_tensor()
    if rank == 0:
        np.save(path + ".y.npy", y.numpy())
        np.save(path + ".aux.npy", aux.numpy())
    dist.destroy_process_group()

if __name__ == "__main__":
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    mp.spawn(run, args=(port, sys.argv[1]), nprocs=8)
"""


def test_expert_parallel_equals_apply_moe_on_8_ranks(tmp_path):
    jcfg = jax_reduced(JAX_REGISTRY["dbrx-132b"]).replace(n_experts=4, top_k=2,
                                                          capacity_factor=8.0)
    cfg = reduced(REGISTRY["dbrx-132b"]).replace(n_experts=4, top_k=2, capacity_factor=8.0)
    jp = JM.init_moe(jax.random.PRNGKey(0), jcfg)
    jx = jax.random.normal(jax.random.PRNGKey(1), (4, 32, jcfg.d_model))
    want, want_aux = JM.apply_moe(jp, jx, jcfg, chunk=32)
    p = {k: torch.from_numpy(np.asarray(v)) for k, v in jp.items()}
    x = torch.from_numpy(np.asarray(jx))
    M.reset_drop_counts()
    port, port_aux = M.apply_moe(p, x, cfg, chunk=32)

    path = str(tmp_path / "moe.npz")
    np.savez(path, x=np.asarray(jx), **{k: np.asarray(v) for k, v in jp.items()})
    script = tmp_path / "ranks.py"                 # spawned ranks import it by name
    script.write_text(RANKS)
    out = subprocess.run([sys.executable, str(script), path], capture_output=True, text=True,
                         cwd=REPO, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
                              "HOME": str(tmp_path), "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    y = np.load(path + ".y.npy")
    aux = float(np.load(path + ".aux.npy"))
    assert y.shape == (4, 32, cfg.d_model)
    assert float(np.max(np.abs(y - np.asarray(want)))) < 1e-5
    assert float(np.max(np.abs(y - port.numpy()))) < 1e-5
    assert abs(aux - float(want_aux)) < 1e-6 and abs(aux - float(port_aux)) < 1e-6
    assert M.drop_counts()[0][0] == 0        # the port's apply_moe dropped nothing
