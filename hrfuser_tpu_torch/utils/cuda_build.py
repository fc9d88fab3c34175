"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

`nvcc` compiles each source for Hopper (`sm_90a`), all sources at once in
parallel processes, and links them into one shared library with a plain C
interface, loaded with `ctypes`. The library goes to `build/` at the
repository root, named by a hash of the sources, so a checkout builds once
at first use and a source edit rebuilds. Nothing is built when this module
is imported.
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
ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
NVCC_FLAGS = [*ARCH, '-std=c++17', '-O3', '-Xcompiler', '-fPIC',
              '-Xptxas', '-v']

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_L = ctypes.c_longlong
# name: (argument types, result type)
_SIGNATURES = {
    'hrf_window_attention': ([_P] * 15 + [_I] * 8 + [_P], _I),
    'hrf_window_attention_plan': ([_I] * 4 + [_IP] * 3, _L),
    'hrf_cross_ffn': ([_P] * 12 + [_I] * 6 + [_P], _I),
    'hrf_cross_ffn_plan': ([_I] * 3 + [_IP] * 3, _L),
    'hrf_roi_align': ([_P] * 4 + [_I] * 8 + [_F] * 4 + [_P, _P]
                      + [_I] * 3 + [_F] + [_I] * 4 + [_P], _I),
    'hrf_roi_align_smem': ([_I] * 3, _L),
    'hrf_jpeg_idct': ([_P, _P, _IP, _I, _I, _P], _I),
    'hrf_jpeg_color': ([_P, _P, _IP] + [_I] * 5 + [_P], _I),
}

# returned by a launcher when no shared-memory plan fits (common.cuh)
ERR_NO_PLAN = 100000


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
    """Compile `csrc/*.cu` into `build/` unless this source set is built:
    one `nvcc -c` per source, all started together, then one link."""
    sources = sorted(CSRC.glob('*.cu'))
    digest = hashlib.sha256()
    for f in sorted(CSRC.glob('*.cu*')):
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    tag = digest.hexdigest()[:16]
    out = BUILD_DIR / f'libhrfuser_kernels_{tag}.so'
    if out.exists():
        return BuildInfo(out, 0.0, 'cached')
    objdir = BUILD_DIR / f'obj_{tag}_{os.getpid()}'
    objdir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    jobs = []
    for src in sources:
        obj = objdir / f'{src.stem}.o'
        jobs.append((obj, subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, '-c', '-o', str(obj), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = '', []
    for obj, proc in jobs:
        log += proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(obj.stem)
    if failed:
        raise RuntimeError(f'nvcc failed for {failed}:\n{log}')
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    proc = subprocess.run([nvcc(), *ARCH, '-shared', '-o', str(tmp),
                           *(str(obj) for obj, _ in jobs)],
                          capture_output=True, text=True)
    log += proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n{log}')
    os.replace(tmp, out)
    shutil.rmtree(objdir, ignore_errors=True)
    return BuildInfo(out, time.perf_counter() - t0, log)


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build().path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _lib = handle
    return _lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status == ERR_NO_PLAN:
        raise ValueError(f'{name}: no shared-memory plan fits this shape')
    if status != 0:
        raise RuntimeError(f'{name}: CUDA error {status} at launch')
