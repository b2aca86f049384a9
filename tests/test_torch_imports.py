"""The port stands alone: nothing under ``src/repro_torch/``, and not
``chip_smoke.py`` or ``tools/chip_phases.py``, imports ``jax``, the JAX
package ``repro`` or ``ml_dtypes`` (which the machine with the card does
not have: the checkpoint stores bf16 and float8 through torch's bit
views)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tools" / "chip_phases.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_files_found():
    assert len(FILES) > 20 and all(f.exists() for f in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
