"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to move to the CPU without being asked."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models.model import build_model, init_params, params_from_jax
from repro_torch.training.data import DataConfig, SyntheticLM
from repro_torch.training.trainer import init_model

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
                  .removesuffix(".__init__")
                  for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    mods = _modules()
    assert "repro_torch.kernels.ops" in mods and len(mods) > 20
    assert {"repro_torch.kernels.decode_attention",
            "repro_torch.kernels.rglru_scan", "repro_torch.models.recurrent",
            "repro_torch.launch.distributed",
            "repro_torch.configs.recurrentgemma_9b",
            "repro_torch.sim.jaxsim", "repro_torch.sim.synthetic",
            "repro_torch.sim.events", "repro_torch.configs.scenarios",
            "repro_torch.core.calibration", "repro_torch.serving.transport",
            "repro_torch.serving.replay",
            "repro_torch.launch.mesh", "repro_torch.training.optimizer",
            "repro_torch.training.trainer", "repro_torch.training.distill",
            "repro_torch.training.data",
            "repro_torch.training.checkpoint",
            "repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.allowlist",
            "repro_torch.analysis.concurrency_rules",
            "repro_torch.analysis.driver", "repro_torch.analysis.findings",
            "repro_torch.analysis.graph_tools",
            "repro_torch.analysis.host_rules",
            "repro_torch.analysis.lane_rules",
            "repro_torch.analysis.runtime",
            "repro_torch.analysis.trace_rules"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", [ROOT / "chip_smoke.py",
                                  *sorted(PKG.rglob("*.py"))],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    roots = _imported_roots(path)
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = get_config("tier-low")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_jax({}, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(get_config("recurrentgemma-9b").reduced(),
                    torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        SyntheticLM(DataConfig(vocab_size=64, seq_len=8,
                               global_batch=2)).batch_at(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        init_model(cfg)
