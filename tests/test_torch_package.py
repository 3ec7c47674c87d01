"""Package boundaries of the port: no JAX and nothing of ``repro`` inside it,
and the device rule (CUDA by default, an error without a card)."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_import_leaves_jax_and_repro_out():
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps({'n': len(names), 'bad': bad}))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=_env(), capture_output=True,
                         text=True, timeout=120, check=True)
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["bad"] == []
    assert result["n"] >= 25


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            roots = [(node.module or "").split(".")[0]]
        else:
            continue
        assert not {"jax", "jaxlib", "repro"} & set(roots), (path, ast.dump(node))


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch, tmp_path):
    _no_cuda(monkeypatch)
    from repro_torch.core import make_policy
    from repro_torch.launch import serve
    from repro_torch.retrieval import DenseIndex, HashedNGramEmbedder, synthetic_dense_index
    from repro_torch.serving import RAGEngine, build_paper_engine
    from repro_torch.serving.experiment import run_policy

    router = make_policy("router_default")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_paper_engine(router)
    with pytest.raises(RuntimeError, match="CUDA"):
        DenseIndex(torch.eye(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        synthetic_dense_index(10, 4)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_policy("fixed_light")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--out", str(tmp_path / "x.csv")])
    index = DenseIndex(torch.eye(4), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        RAGEngine(router, index, HashedNGramEmbedder(4))
    assert build_paper_engine(router, device="cpu").index.embeddings.device.type == "cpu"


def test_chip_smoke_refuses_without_a_card_or_a_checkout(tmp_path):
    here = None
    if not torch.cuda.is_available():
        here = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                              capture_output=True, text=True, timeout=120)
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(ROOT / "chip_smoke.py", lone)
    alone = subprocess.run([sys.executable, "chip_smoke.py"], cwd=lone,
                           capture_output=True, text=True, timeout=120)
    for proc in [alone] if torch.cuda.is_available() else [here, alone]:
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
