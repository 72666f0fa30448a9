"""No file of the benchmark imports JAX, jaxlib, flax or the JAX package
``repro``, compared by each import's whole top-level name (``repro_torch``
is another name); the plain references import nothing of the port either."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FILES = sorted(BENCH.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}
BANNED_IN_REFERENCE = BANNED | {"repro_torch", "harness"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_check_sees_every_file():
    assert len(FILES) > 20 and BENCH / "run.py" in FILES


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_banned_import(path):
    banned = BANNED_IN_REFERENCE if "reference" in path.relative_to(BENCH).parts else BANNED
    assert not top_level_imports(path) & banned


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.models\nfrom repro.core import x\nimport jaxlib as j\n")
    assert top_level_imports(f) == {"repro_torch", "repro", "jaxlib"}
