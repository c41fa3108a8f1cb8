"""The port's boundaries: ``dllama_tpu_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package (checked in a fresh interpreter
and by an AST scan), the port's engine keeps the JAX engine's calling surface
(``tests/golden_assets.replay_reference_driver`` runs both), and the smoke
script refuses to run without a GPU or outside a checkout."""

from __future__ import annotations

import ast
import inspect
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "dllama_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "dllama_tpu")


def _modules() -> list[str]:
    mods = []
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__main__":
            continue  # runs the CLI when imported
        if parts[-1] == "__init__":
            parts = parts[:-1]
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_fresh_import_of_every_module_loads_no_jax():
    mods = _modules()
    assert "dllama_tpu_torch.ops.quant_matmul" in mods and len(mods) > 20
    assert "dllama_tpu_torch.runtime.speculative" in mods
    for m in ("telemetry", "failpoints", "watchdog", "flightrec", "introspection",
              "profiling", "roofline"):
        assert f"dllama_tpu_torch.runtime.{m}" in mods
    code = ("import sys\n"
            f"for m in {mods!r}:\n"
            "    __import__(m)\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib') "
            "or m.startswith(('jax.', 'jaxlib.', 'dllama_tpu.')) or m == 'dllama_tpu')\n"
            "print('BAD', bad)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "BAD []" in r.stdout, r.stdout


@pytest.mark.parametrize("path", sorted(str(p.relative_to(REPO)) for p in PKG.rglob("*.py"))
                         + ["chip_smoke.py"])
def test_ast_scan_finds_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:  # relative: stays inside the port's package
                continue
            names = [node.module or ""]
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
              and node.func.id == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names = [node.args[0].value]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_engine_keeps_the_jax_engine_surface():
    """``replay_reference_driver`` calls ``eng.tokenizer.encode(...,
    is_start=True)``, ``eng.generate(ids, max_tokens=..., stop_on_eos=False)``
    and ``eng.tokenizer.decode`` / ``reset_decoder`` on either engine."""
    from dllama_tpu.runtime.engine import InferenceEngine as JaxEngine
    from dllama_tpu.tokenizer.bpe import Tokenizer as JaxTokenizer
    from dllama_tpu_torch.runtime.engine import InferenceEngine
    from dllama_tpu_torch.tokenizer.bpe import Tokenizer

    def params(fn):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()]

    for name in ("generate", "prefill", "decode_step", "next_token", "perplexity",
                 "score_nll", "reset", "close", "speculative_tokens", "commit_chunk"):
        assert params(getattr(InferenceEngine, name)) == params(getattr(JaxEngine, name)), name
    for name in ("encode", "decode", "reset_decoder", "is_eos", "decode_all"):
        assert params(getattr(Tokenizer, name)) == params(getattr(JaxTokenizer, name)), name
    assert "tokenizer" in inspect.getsource(InferenceEngine.__init__)


def _smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_a_gpu():
    r = _smoke(REPO)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "torch.cuda.is_available() is False" in r.stderr


def test_chip_smoke_refuses_outside_a_checkout(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    r = _smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
