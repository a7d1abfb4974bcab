"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
neither JAX nor anything of the JAX package ``repro``."""
from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(
    r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.MULTILINE)


def test_import_loads_no_jax_and_no_repro():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.gson, repro_torch.convert\n"
        "import repro_torch.kernels.find_winners, "
        "repro_torch.kernels.update_phase\n"
        "import repro_torch.kernels.update_phase.sparse, "
        "repro_torch.gson.autotune, repro_torch.core.gson.single, "
        "repro_torch.core.gson.engine\n"
        "import repro_torch.ann, repro_torch.ann.grid, "
        "repro_torch.ann.windowed, repro_torch.data.pointclouds, "
        "repro_torch.configs.soam_paper\n"
        "import repro_torch.gson.faults, repro_torch.serving, "
        "repro_torch.serving.engine\n"
        "import repro_torch.core.gson.distributed, repro_torch.ft, "
        "repro_torch.gson.elastic\n"
        "import repro_torch.utils, repro_torch.utils.timing, "
        "repro_torch.utils.trees, repro_torch.models, "
        "repro_torch.models.common, repro_torch.models.attention, "
        "repro_torch.models.transformer, repro_torch.models.registry\n"
        "import repro_torch.configs, repro_torch.data.tokens, "
        "repro_torch.launch, repro_torch.launch.serve\n"
        "import repro_torch.training, repro_torch.training.optimizer, "
        "repro_torch.training.trainer, repro_torch.training.compression, "
        "repro_torch.launch.steps, repro_torch.launch.train, "
        "repro_torch.models.moe\n"
        "import repro_torch.models.ssm, repro_torch.models.ssm_lm, "
        "repro_torch.models.hybrid, repro_torch.models.encdec\n"
        "import repro_torch.launch.mesh, repro_torch.models.placement, "
        "repro_torch.models.act_sharding\n"
        "from repro_torch.configs import all_configs\n"
        "all_configs()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in [
        *PORT.rglob("*.py"), ROOT / "chip_smoke.py",
        *(ROOT / "examples").glob("torch_*.py")]))
def test_source_imports_no_jax_and_no_repro(path):
    src = (ROOT / path).read_text()
    assert not FORBIDDEN.search(src), f"{path} imports jax or repro"
