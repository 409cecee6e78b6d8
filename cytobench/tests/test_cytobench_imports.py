"""Nothing under cytobench/ imports JAX or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's); the
reference imports nothing of the port; nothing reads the JAX benchmark."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "yolo_sam_inference_tpu"}
PORT = "yolo_sam_inference_tpu_torch"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_no_jax_anywhere():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for f in files:
        assert not FORBIDDEN & set(_imports(f)), f


def test_reference_takes_nothing_of_the_port():
    for f in sorted((HERE / "reference").rglob("*.py")):
        assert PORT not in set(_imports(f)), f
        assert PORT not in f.read_text(), f


def test_families_load_nothing_of_the_port():
    """A family's module, which the reference's embedding and crops are
    taken from, imports the port only inside the function that builds it."""
    files = sorted((HERE / "families").glob("*.py"))
    assert files
    for f in files:
        top = [n for n in ast.parse(f.read_text()).body
               if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.module}
        assert PORT not in names, f


def test_reads_no_jax_benchmark():
    for f in sorted(HERE.rglob("*.py")):
        if f.parent.name == "tests":
            continue
        text = f.read_text()
        assert "BENCH_" not in text and "bench.py" not in text, f


def test_top_level_names_compared_whole():
    from cytobench.run import forbidden_modules

    import yolo_sam_inference_tpu_torch  # noqa: F401  (the port's name starts with the JAX one's)
    assert not [m for m in forbidden_modules() if m.startswith(PORT)]
