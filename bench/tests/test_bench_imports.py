"""Nothing under bench/ imports JAX, Flax or the JAX package, compared by
whole top-level name (the port's name begins with the JAX package's)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    tops = set(imported_tops(path))
    assert not tops & BANNED, f"{path} imports {sorted(tops & BANNED)}"


def test_top_level_names_compare_whole():
    src = "import repro_torch.models\nfrom repro_torch import x\n"
    tmp = ast.parse(src)
    names = {n.names[0].name.split(".")[0] if isinstance(n, ast.Import)
             else n.module.split(".")[0] for n in tmp.body}
    assert names == {"repro_torch"} and not names & BANNED


def test_harness_loads_no_jax():
    root = BENCH.parent
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import bench.harness, bench.probe, bench.profile, bench.weights\n"
        "import bench.systems.fleet, bench.systems.stream\n"
        "import bench.traffic.fleet_open, bench.traffic.closed_chat\n"
        "import bench.reference.resnet, bench.reference.olmo\n"
        "import repro_torch.serving.fleet, repro_torch.serving.streaming\n"
        "from bench.harness import banned_modules\n"
        "print(banned_modules())\n") % (str(root), str(root / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"
