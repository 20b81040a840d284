"""Build-on-first-use for the port's CUDA kernels (nvcc -> .so -> ctypes).

Each kernel library is one or more `csrc/*.cu` files with a plain C entry
point, compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into `build/kernels/lib<name>.so` at the repository root (listed in
.gitignore). A sha256 of the sources and the command is kept in a
`<so>.srchash` sidecar, and the library is rebuilt whenever the sidecar
is missing or differs: content hashing, not mtimes, because a fresh
checkout sets every mtime. Concurrent first builds compile to a pid-unique
temporary path and publish with os.replace, so no half-written library is
ever loadable under the final name (the scheme of
parseq_tpu/utils/native_build.py).

Unlike the JAX package's g++ builder, a failed build raises: the port has
no fallback for a CUDA tensor, so a kernel that does not build is an error.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'kernels'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC')


class KernelBuildError(RuntimeError):
    pass


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then /usr/local/cuda/bin."""
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    which = shutil.which('nvcc')
    if which:
        cands.append(Path(which))
    cands.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise KernelBuildError(
        'nvcc not found (looked in $CUDA_HOME/bin, $PATH, /usr/local/cuda/bin); '
        'the CUDA toolkit is needed to build the port\'s kernels')


def _build_hash(sources, cmd) -> str:
    h = hashlib.sha256()
    for s in sources:
        h.update(s.name.encode() + b'\0' + s.read_bytes())
    h.update('\0'.join(cmd).encode())
    return h.hexdigest()


def ensure_built(name: str, sources, *, timeout=600) -> Path:
    """Compile `sources` (paths under csrc/) into lib<name>.so if missing or
    stale and return its path. Raises KernelBuildError on any failure."""
    sources = [Path(s) for s in sources]
    for s in sources:
        if not s.is_file():
            raise KernelBuildError(f'kernel source {s} missing')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f'lib{name}.so'
    sidecar = so.with_name(so.name + '.srchash')
    nvcc = find_nvcc()
    cmd = [nvcc, *NVCC_FLAGS, *map(str, sources), '-o', str(so)]
    want = _build_hash(sources, cmd[1:])
    if so.exists() and sidecar.exists() and sidecar.read_text().strip() == want:
        return so
    tmp_so = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    tmp_sidecar = sidecar.with_name(f'{sidecar.name}.{os.getpid()}.tmp')
    build_cmd = cmd[:-1] + [str(tmp_so)]
    try:
        proc = subprocess.run(build_cmd, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise KernelBuildError(
                f'nvcc failed building {name} (exit {proc.returncode}):\n'
                f'{" ".join(build_cmd)}\n{proc.stdout}\n{proc.stderr}')
        tmp_sidecar.write_text(want)
        os.replace(tmp_so, so)
        os.replace(tmp_sidecar, sidecar)
    finally:
        tmp_so.unlink(missing_ok=True)
        tmp_sidecar.unlink(missing_ok=True)
    return so


@functools.cache
def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """Build (if needed) and dlopen lib<name>.so; one handle per process."""
    return ctypes.CDLL(str(ensure_built(name, sources)))
