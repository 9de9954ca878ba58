"""Guards on the port: it never imports JAX or the JAX package, never calls
a library attention or ``torch.compile``, and its kernel build raises
instead of handing back a stub when ``nvcc`` is missing."""
import ast
import shutil
from pathlib import Path

import pytest

from repro_torch.kernels import build

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
SMOKE = ROOT / "chip_smoke.py"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "flax", "optax")


@pytest.mark.parametrize("path", PORT_FILES + [SMOKE],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_calls_no_library_attention_or_compile():
    for path in PORT_FILES:
        tree = ast.parse(path.read_text())
        attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
        assert not attrs & {"scaled_dot_product_attention", "compile"}, path


def test_build_raises_without_nvcc(tmp_path):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("nvcc is installed here")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.load("flash_attention", build_dir=tmp_path)
    assert list(tmp_path.iterdir()) == []


def test_library_name_tracks_the_source(tmp_path):
    """The build is keyed by a hash of the sources and flags."""
    p = build._lib_path("flash_attention", tmp_path)
    assert p.parent == tmp_path and p.name.startswith("libflash_attention-")
    assert p == build._lib_path("flash_attention", tmp_path)


# every Python file the port added: ruff's E501 (pyproject.toml's line-length)
# holds them as it holds the reference's
ADDED = sorted(set(PORT_FILES + [SMOKE]
                   + list((ROOT / "tests").glob("test_torch_*.py"))
                   + list((ROOT / "tools").glob("*.py"))))
LINE_LENGTH = 88


@pytest.mark.parametrize("path", ADDED, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_line_over_the_line_length(path):
    """No line longer than 88 characters unless it is one word (ruff's E501
    skips those)."""
    long = [i for i, line in enumerate(path.read_text().splitlines(), 1)
            if len(line) > LINE_LENGTH and len(line.split()) > 1]
    assert not long, f"{path.relative_to(ROOT)}: lines {long} exceed {LINE_LENGTH}"


def test_wheel_carries_the_cuda_sources():
    """pyproject.toml's package data covers every source the build reads,
    and the ``test`` extra pulls in torch."""
    import fnmatch
    import tomllib
    conf = tomllib.loads((ROOT / "pyproject.toml").read_text())
    pats = conf["tool"]["setuptools"]["package-data"]["repro_torch"]
    pkg = ROOT / "src" / "repro_torch"
    for f in (pkg / "kernels" / "csrc").iterdir():
        rel = str(f.relative_to(pkg))
        assert any(fnmatch.fnmatch(rel, p) for p in pats), rel
    extras = conf["project"]["optional-dependencies"]
    assert "repro[torch]" in extras["test"]
    assert any(d.startswith("torch>=") for d in extras["torch"])
