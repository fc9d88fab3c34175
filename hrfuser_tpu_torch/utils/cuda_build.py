"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles every source into one shared library with a plain C
interface for Hopper (`sm_90a`), loaded with `ctypes`. The library goes to
`build/` at the repository root, named by a hash of the sources, so a
checkout builds once at first use and a source edit rebuilds. Nothing is
built when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple, Optional

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    'hrf_window_attention': [_P] * 12 + [_I] * 7 + [_P],
    'hrf_cross_ffn': [_P] * 9 + [_I] * 6 + [_P],
    'hrf_roi_align': [_P] * 4 + [_I] * 8 + [_F] * 4 + [_P, _P]
                     + [_I] * 3 + [_F, _I, _P],
}


class BuildInfo(NamedTuple):
    """What `build()` did: library path, nvcc seconds, nvcc output."""
    path: Path
    seconds: float
    log: str


_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of the CUDA compiler."""
    found = shutil.which('nvcc')
    if found:
        return found
    home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
    cand = Path(home) / 'bin' / 'nvcc'
    if cand.exists():
        return str(cand)
    raise RuntimeError('nvcc not found: the CUDA kernels need the CUDA '
                       'toolkit (set CUDA_HOME or put nvcc on PATH)')


def build() -> BuildInfo:
    """Compile `csrc/*.cu` into `build/` unless this source set is built."""
    sources = sorted(CSRC.glob('*.cu'))
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob('*.cu*')):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    out = BUILD_DIR / f'libhrfuser_kernels_{digest.hexdigest()[:16]}.so'
    if out.exists():
        return BuildInfo(out, 0.0, 'cached')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n{log}')
    os.replace(tmp, out)
    return BuildInfo(out, seconds, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build().path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f'{name}: CUDA error {status} at launch')
