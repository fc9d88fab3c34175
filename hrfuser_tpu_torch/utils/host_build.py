"""Build and load the port's host C++ libraries (`csrc/*.cpp`).

Each library is one source compiled by `g++ -O3 -std=c++17 -shared
-fPIC` into `build/` at the repository root at first use, named by a hash
of the source, and bound with `ctypes` (which releases the GIL during a
call). A build writes a temporary file and renames it into place, so a
process never loads half a library; a cached library that does not load
(built on another machine) is built again. A missing `g++` or a failed
build raises `RuntimeError`. Nothing is built when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Callable, Dict, List


def build(source: Path, build_dir: Path, stem: str, what: str,
          again: bool = False) -> Path:
    """Compile `source` into `build_dir/<stem>_<hash>.so` unless that
    library exists (or `again`); returns its path. `what` names the
    library in errors."""
    tag = hashlib.sha256(Path(source).read_bytes()).hexdigest()[:16]
    out = Path(build_dir) / f'{stem}_{tag}.so'
    if out.exists() and not again:
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.{os.getpid()}.tmp')
    cmd = ['g++', '-O3', '-std=c++17', '-shared', '-fPIC', str(source),
           '-o', str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f'{what} needs g++: {e}') from e
    if proc.returncode != 0:
        raise RuntimeError(f'building {what} failed\n{" ".join(cmd)}\n'
                           f'{proc.stderr}')
    os.replace(tmp, out)
    return out


def load(build_fn: Callable[..., Path], what: str,
         signatures: Dict[str, List]) -> ctypes.CDLL:
    """The library `build_fn(again=False)` gives, loaded, each function of
    `signatures` given its argument types and an int result; built again
    once if the cached one does not load."""
    try:
        handle = ctypes.CDLL(str(build_fn()))
    except OSError:
        path = build_fn(again=True)
        try:
            handle = ctypes.CDLL(str(path))
        except OSError as e:
            raise RuntimeError(f'{what} {path} does not load ({e})') from e
    for name, argtypes in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle
