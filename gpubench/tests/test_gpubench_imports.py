"""Nothing the benchmark loads is JAX or the JAX package (top-level names
compared whole: ``repro_torch`` begins with ``repro``), and the
reference loads nothing of the program."""
from __future__ import annotations

import json
import subprocess
import sys

from gpubench.tests.conftest import REPO, TINY_CELL

_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from gpubench import run
res = run.run_cell(run.Path({root!r}), {cell!r}, 5, 0.2, True, device="cpu")
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

_REF = """
import json, sys
sys.path.insert(0, {repo!r})
import torch
from gpubench.reference import compare, gson_step as ref
p = ref.Params(eps_b=0.05, eps_n=0.005, age_max=30.0,
               insertion_threshold=0.2, firing_threshold=0.3, tau_b=0.3,
               tau_n=0.1, h_min=0.1, thr_decay=0.95, thr_recover=1.01,
               thr_min_frac=0.05, stuck_window=20, freeze_stable=True,
               min_m=4, refresh_every=5, check_every=10)
net = ref.init(torch.randn(2, 3), 32, 16, 0.2)
g = torch.Generator().manual_seed(0)
for t in range(12):
    x = torch.randn(64, 3, generator=g)
    x = x / x.norm(dim=1, keepdim=True)
    net, _ = ref.step(net, x, torch.randperm(64, generator=g), t, p)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package(tiny_root):
    names = _top_level(_RUN.format(root=str(tiny_root), cell=TINY_CELL))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    names = _top_level(_REF.format(repo=str(REPO)))
    assert "gpubench" in names
    assert not names & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_names_are_compared_whole():
    from gpubench import run
    assert run.forbidden_modules(["repro_torch.gson", "repro_torchx",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["repro.core.gson", "jax._src",
                                  "flax"]) == ["flax", "jax", "repro"]
