"""`hrfuser_tpu_torch` never imports JAX, flax or the JAX package.

Checked in a fresh interpreter (this test process has JAX loaded by
`tests/conftest.py`) that runs the tiny slice end to end on the CPU, and
statically over every module of the package.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / 'hrfuser_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'hrfuser_tpu')

_SCRIPT = """
import sys
import numpy as np
from hrfuser_tpu_torch import init_detector
det = init_detector('tiny_fusion_test', 'cpu', seed=0)
rng = np.random.default_rng(0)
img = rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
mods = [rng.normal(0, 1, (1, 64, 96, 3)).astype(np.float32)
        for _ in range(2)]
out = det(img, mods)
assert tuple(out.boxes.shape) == (1, 20, 4), out.boxes.shape
assert bool(out.boxes.isfinite().all())
bad = sorted(m for m in sys.modules if m.split('.')[0] in {forbidden})
assert not bad, bad
print('ok')
"""


def test_tiny_slice_runs_without_jax_in_a_fresh_process():
    env = {**os.environ, 'PYTHONPATH': ''}
    proc = subprocess.run(
        [sys.executable, '-c', _SCRIPT.format(forbidden=set(FORBIDDEN))],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().endswith('ok')


def test_no_module_of_the_package_imports_jax():
    offenders = []
    for path in PKG.rglob('*.py'):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or '']
            else:
                continue
            offenders += [f'{path.relative_to(ROOT)}: {n}' for n in names
                          if n.split('.')[0] in FORBIDDEN]
    assert offenders == []
