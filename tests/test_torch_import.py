"""repro_torch stands alone: no JAX, nothing of the reference package."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def test_importing_every_module_leaves_jax_out():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
        " or m == 'repro')\n"
        "assert not bad, bad\n"
        "lm = {'repro_torch.' + m for m in ('models.config', 'models.layers',\n"
        "      'models.transformer', 'models.model', 'distributed.sharding', 'obs.metrics',\n"
        "      'obs.drift', 'obs.trace', 'serve.sampling', 'serve.page_manager',\n"
        "      'serve.scheduler', 'serve.engine', 'launch.serve', 'configs.olmo_1b',\n"
        "      'checkpoint.checkpoint', 'data.pipeline', 'distributed.watchdog', 'train.step',\n"
        "      'launch.train', 'launch.mesh', 'launch.time_serving', 'distributed.collectives',\n"
        "      'train.grad_compress', 'distributed.pipeline')}\n"
        "assert lm <= set(names), lm - set(names)\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 60   # every module of the port was imported


def _imports(path: Path) -> set[str]:
    names: set[str] = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return names


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_reference(path):
    roots = {n.split(".")[0] for n in _imports(path)}
    assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


def test_resolve_device_raises_without_a_card():
    from repro_torch import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA requested"):
            resolve_device()


def test_phi_config_validates_against_the_ported_impl_names():
    from repro.kernels.dispatch import IMPLS as REF_IMPLS
    from repro_torch.core.patterns import PhiConfig
    from repro_torch.kernels import IMPLS

    assert IMPLS == REF_IMPLS
    for name in IMPLS:
        assert PhiConfig(impl=name).impl == name
    with pytest.raises(ValueError):
        PhiConfig(impl="bogus")
    with pytest.raises(ValueError):
        PhiConfig(k=1)
