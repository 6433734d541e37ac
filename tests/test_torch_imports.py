"""The PyTorch port stands alone: no module of shardmerge_tpu_torch/, no
script that drives it on the card (chip_smoke.py, scripts/*_torch.py) and
no example of it (examples/*_torch.py) imports JAX or the JAX package
(shardmerge_tpu). Their import statements
are read with ``ast``, so docstrings and comments that name JAX files do
not count, and nothing is imported to check."""

import ast
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
FILES = sorted(
    [p for p in (REPO / "shardmerge_tpu_torch").rglob("*.py") if "_build" not in p.parts]
    + [REPO / "chip_smoke.py"]
    + sorted((REPO / "scripts").glob("*_torch.py"))
    + sorted((REPO / "examples").glob("*_torch.py"))
)
FORBIDDEN = ("jax", "jaxlib", "shardmerge_tpu")


def _imported(tree):
    """Every absolute module name the file imports, at any depth."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
            "import_module",
            "__import__",
        ):
            if node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
                yield node.args[0].value


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_the_guard_reads_imports_not_text():
    src = (
        '"""Counterpart of shardmerge_tpu/models/llama.py (uses jax there)."""\n'
        "# import jax\n"
        "import shardmerge_tpu_torch.models\n"
        "from shardmerge_tpu_torch import kernel_build\n"
        "def f():\n"
        "    import jax.numpy as jnp\n"
        "    from shardmerge_tpu.models import quant\n"
        "    return importlib.import_module('jaxlib')\n"
    )
    names = list(_imported(ast.parse(src)))
    assert [n for n in names if _forbidden(n)] == ["jax.numpy", "shardmerge_tpu.models", "jaxlib"]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_port_file_imports_neither_jax_nor_the_jax_package(path):
    names = [n for n in _imported(ast.parse(path.read_text(), filename=str(path))) if _forbidden(n)]
    assert not names, f"{path.relative_to(REPO)} imports {names}"


def test_the_guard_covers_every_module_of_the_checkpoint_slice():
    """The host-layer modules, the checkpoint tools and the native build are
    among the files read above."""
    port = REPO / "shardmerge_tpu_torch"
    new = [port / "io" / m for m in ("download.py", "index.py", "native.py", "writer.py")]
    new += [port / "tools" / m for m in ("__init__.py", "fuse_lora.py", "extract_lora.py", "quantize_checkpoint.py",
                                         "verify_safetensors.py", "inspect_model.py", "rewrite_reorder.py",
                                         "convert_pytorch_to_hf.py")]
    new += [port / "models" / "loader.py", port / "backend.py", port / "cli.py"]
    assert all(p.is_file() for p in new)
    assert set(new) <= set(FILES)


def test_the_guard_reads_the_merge_across_ranks():
    """The modules of the merge across ranks and the script that runs it on
    several cards are among the files read."""
    names = {str(p.relative_to(REPO)) for p in FILES}
    wanted = {f"shardmerge_tpu_torch/parallel/{m}.py" for m in ("__init__", "comm", "fft2d", "merge", "multihost")}
    assert wanted | {"scripts/merge_ranks_torch.py"} <= names


def test_the_tensor_parallel_modules_are_guarded():
    """The tensor-parallel placement and protocol modules and the four-GPU
    decoding script are among the files the guard reads."""
    names = {str(p.relative_to(REPO)) for p in FILES}
    assert {"shardmerge_tpu_torch/parallel/train.py", "shardmerge_tpu_torch/parallel/tp.py",
            "scripts/serve_ranks_torch.py"} <= names


def test_the_guard_reads_the_training_modules():
    """The train step's modules, the script that runs it on several cards
    and the recipe are among the files read."""
    names = {str(p.relative_to(REPO)) for p in FILES}
    wanted = {f"shardmerge_tpu_torch/parallel/{m}.py" for m in ("train", "optim", "mesh", "checkpoint", "lora")}
    assert wanted | {"scripts/train_ranks_torch.py", "examples/train_recipe_torch.py"} <= names
