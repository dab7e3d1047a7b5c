"""Import hygiene of the port: no JAX, nothing of the reference package,
and Triton only inside the functions that launch a kernel."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module name, at module level) for every import in the file."""
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name, at_top in _imports(tree):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib"), f"{path}: imports {name}"
        assert root != "repro", f"{path}: imports the reference ({name})"
        assert not (root == "triton" and at_top), \
            f"{path}: imports triton at module level"


def test_scan_covers_the_port():
    names = {p.name for p in PORT_FILES}
    assert {"chip_smoke.py", "ops.py", "topology.py", "session.py"} <= names
    assert len(PORT_FILES) >= 20
