"""paddle_tpu_torch package rules: no JAX and no paddle_tpu import anywhere
in the port or chip_smoke.py; entry points default to the card and raise
where CUDA is absent; the package imports where nvcc is absent, and the
kernel build raises there instead of substituting a plain version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "paddle_tpu", "ml_dtypes"}

torch.set_num_threads(1)


def _port_files():
    return sorted((ROOT / "paddle_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_never_imports_jax_or_the_reference():
    files = _port_files()
    assert len(files) > 10
    bad = {str(f.relative_to(ROOT)): sorted(_imported_roots(f) & FORBIDDEN)
           for f in files if _imported_roots(f) & FORBIDDEN}
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    from paddle_tpu_torch.core.device import resolve_device
    from paddle_tpu_torch.inference import LLMEngine
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LlamaForCausalLM(LlamaConfig.tiny())
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine(model, cache_impl="paged")
    assert resolve_device("cpu") == torch.device("cpu")


def test_package_imports_without_nvcc(tmp_path):
    """A fresh interpreter with no CUDA compiler reachable imports every
    module of the port (kernels build at first use, never at import), and
    none of them imports jax or any module of the reference package."""
    mods = sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts).replace(
            ".__init__", "")
        for f in (ROOT / "paddle_tpu_torch").rglob("*.py"))
    assert "paddle_tpu_torch.serving.kv_transport" in mods
    code = "import importlib, sys\n" \
        f"for m in {mods!r}: importlib.import_module(m)\n" \
        "assert 'jax' not in sys.modules, 'jax imported'\n" \
        "assert 'ml_dtypes' not in sys.modules, 'ml_dtypes imported'\n" \
        "ref = sorted(n for n in sys.modules if n == 'paddle_tpu' or " \
        "n.startswith('paddle_tpu.'))\n" \
        "assert not ref, f'reference modules imported: {ref}'\n" \
        "print('ok')"
    env = {"PATH": str(tmp_path), "PYTHONPATH": str(ROOT),
           "HOME": str(tmp_path)}
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_kernel_build_raises_without_nvcc(tmp_path, monkeypatch):
    from paddle_tpu_torch.ops.kernels import _build
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
