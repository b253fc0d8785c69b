"""The port stands alone: no file of ``lighthouse_tpu_torch/``, and not
``chip_smoke.py``, imports ``jax`` or anything of ``lighthouse_tpu`` (an
AST scan, so nothing is imported to check it)."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "lighthouse_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "lighthouse_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_roots(path):
    with open(path, encoding="utf-8") as fh:
        tree = ast.parse(fh.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_scan_covers_the_port():
    names = {os.path.relpath(p, REPO) for p in _sources()}
    assert "chip_smoke.py" in names
    assert os.path.join("lighthouse_tpu_torch", "torch_backend.py") in names
    assert os.path.join("lighthouse_tpu_torch", "ops", "mont_mul.py") in names
    assert os.path.join("lighthouse_tpu_torch", "ops", "htc.py") in names
    assert os.path.join("lighthouse_tpu_torch", "ops", "tkernel_htc.py") in names
    assert os.path.join("lighthouse_tpu_torch", "ops", "msm.py") in names
    assert os.path.join("lighthouse_tpu_torch", "ops", "coop.py") in names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"
