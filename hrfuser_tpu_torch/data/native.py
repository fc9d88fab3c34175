"""ctypes bindings of the host JPEG decoder (`csrc/loader.cpp`).

Counterpart of `hrfuser_tpu/data/native.py`, reduced to the two JPEG
functions the loader calls: `jpeg_shape` and `decode_jpeg_bgr`
(libjpeg); PNG files go through `data/png.py`. The library is built with
`g++ -O3 -shared -fPIC ... -ljpeg` into `build/` at the repository root
at first use, named by a hash of the source, so a checkout builds once
and an edit rebuilds. A cached library that does not load (built on a
machine with another libjpeg) is built again. Nothing is built when this
module is imported. A build that fails raises with `g++`'s output: there
is no second decoder to fall back on. The card's machine has no libjpeg
headers, so there the build fails and a JPEG raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / 'csrc' / 'loader.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build'

_SIGNATURES = {
    'jpeg_shape': [ctypes.c_char_p] + [ctypes.POINTER(ctypes.c_int)] * 3,
    'decode_jpeg_bgr': [ctypes.c_char_p, ctypes.c_void_p] + [ctypes.c_int] * 2,
}

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()          # the loader's prefetch thread may build


def build(again: bool = False) -> Path:
    """Compile `csrc/loader.cpp` into `build/` unless this source is
    built (or `again`); returns the library's path. Raises
    `RuntimeError` with the compiler's output if it cannot be built."""
    tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out = BUILD_DIR / f'libhrfuser_loader_{tag}.so'
    if out.exists() and not again:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', '-O3', '-shared', '-fPIC', str(SOURCE), '-o', str(tmp),
           '-ljpeg']
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'the JPEG decoder needs g++: {e}') from e
    if proc.returncode != 0:
        raise RuntimeError(
            f'building the JPEG decoder failed: it needs libjpeg with its '
            f'headers (PNG files decode without it)\n'
            f'{" ".join(cmd)}\n{proc.stderr}')
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded decoder library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            try:
                handle = ctypes.CDLL(str(build()))
            except OSError:             # built on another machine
                path = build(again=True)
                try:
                    handle = ctypes.CDLL(str(path))
                except OSError as e:
                    raise RuntimeError(f'the JPEG decoder {path} does not '
                                       f'load: it needs libjpeg ({e})') from e
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def jpeg_shape(path: str) -> Tuple[int, int, int]:
    """A JPEG's (height, width, components)."""
    h, w, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    rc = lib().jpeg_shape(path.encode(), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c))
    if rc:
        raise IOError(f'jpeg_shape({path}) rc={rc}')
    return h.value, w.value, c.value


def decode_jpeg_bgr(path: str) -> np.ndarray:
    """A JPEG as uint8 BGR [H, W, 3]."""
    h, w, _ = jpeg_shape(path)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib().decode_jpeg_bgr(path.encode(), out.ctypes.data, h, w)
    if rc:
        raise IOError(f'decode_jpeg_bgr({path}) rc={rc}')
    return out
