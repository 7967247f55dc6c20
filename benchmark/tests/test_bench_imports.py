"""Nothing under benchmark/ but its tests imports JAX, jaxlib, flax or
the JAX package, by whole top-level names (`ccgp_tpu_torch` is not
`ccgp_tpu`); and the reference imports nothing of the measured package."""
import ast
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "ccgp_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    return [p for p in (BENCH_DIR / sub).rglob("*.py")
            if "tests" not in p.relative_to(BENCH_DIR).parts]


def test_no_jax_anywhere():
    files = _sources()
    assert len(files) > 10
    bad = {str(p): sorted(set(_imports(p)) & FORBIDDEN) for p in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_whole_names_only():
    assert "ccgp_tpu_torch".split(".")[0] not in FORBIDDEN


def test_reference_is_plain():
    for p in _sources("reference"):
        assert set(_imports(p)) <= {"__future__", "math", "dataclasses",
                                    "typing", "torch", "reference"}, p


def test_checks_import_no_program():
    files = _sources("checks")
    assert files
    for p in files:
        assert set(_imports(p)) <= {"__future__", "math", "numpy", "torch",
                                    "harness", "reference"}, p
