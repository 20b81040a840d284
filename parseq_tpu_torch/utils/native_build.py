"""Build-on-first-use for the port's host-side C++ helpers (g++ -> .so -> ctypes).

Three helpers have a native core: the batch edit distance
(`utils/editdist.cpp`), the LMDB reader and the JPEG decoder
(`data/native/*.cpp`). Each is compiled with

    g++ -O2 -shared -fPIC -std=c++17 <src> -o build/native/lib<name>.so [flags]

into `build/native/` at the repository root (listed in .gitignore), never
next to its source. A sha256 of the source and the command is kept in a
`<so>.srchash` sidecar and the library is rebuilt whenever the sidecar is
missing or differs; concurrent first builds (forked loader workers)
compile to a pid-unique temporary path and publish with os.replace, so no
half-written library is ever loadable under the final name (the scheme of
kernels/build.py).

The fallback is narrow. A helper falls back on its pure-Python version only
when the toolchain is absent: no `g++` on PATH, or, for a helper that needs
one, no header such as `jpeglib.h` on g++'s include path. That logs one
WARNING and `status()` reports it. When the toolchain is there, a source
that fails to compile or a library that fails to load raises
NativeBuildError, so a broken source cannot pass silently.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
from pathlib import Path

log = logging.getLogger(__name__)

BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
CXX_FLAGS = ('-O2', '-shared', '-fPIC', '-std=c++17')

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL | None] = {}
_status: dict[str, dict] = {}


class NativeBuildError(RuntimeError):
    pass


def find_gxx() -> str | None:
    """g++ on PATH, or None."""
    return shutil.which('g++')


def has_header(header: str, gxx: str | None = None) -> bool:
    """True if `#include <header>` preprocesses with g++ (False without g++)."""
    gxx = gxx or find_gxx()
    if gxx is None:
        return False
    proc = subprocess.run([gxx, '-x', 'c++', '-E', '-o', os.devnull, '-'],
                          input=f'#include <{header}>\n', capture_output=True, text=True,
                          timeout=60)
    return proc.returncode == 0


def missing_toolchain(headers=()) -> str | None:
    """Why the toolchain for a helper that includes `headers` is absent, or
    None when it is there."""
    gxx = find_gxx()
    if gxx is None:
        return 'no g++ on PATH'
    for h in headers:
        if not has_header(h, gxx):
            return f'no {h} on the include path of {gxx}'
    return None


def _build_hash(src: Path, cmd) -> str:
    h = hashlib.sha256(src.read_bytes())
    h.update('\0'.join(cmd).encode())
    return h.hexdigest()


def ensure_built(name: str, src, extra_flags=(), *, timeout=300) -> Path:
    """Compile `src` into build/native/lib<name>.so if missing or stale and
    return its path. Raises NativeBuildError when g++ fails."""
    src = Path(src)
    if not src.is_file():
        raise NativeBuildError(f'native source {src} missing')
    gxx = find_gxx()
    if gxx is None:
        raise NativeBuildError('no g++ on PATH')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f'lib{name}.so'
    sidecar = so.with_name(so.name + '.srchash')
    cmd = ['g++', *CXX_FLAGS, str(src), '-o', str(so), *extra_flags]
    want = _build_hash(src, cmd)
    if so.exists() and sidecar.exists() and sidecar.read_text().strip() == want:
        return so
    tmp_so = so.with_name(f'{so.name}.{os.getpid()}.tmp')
    tmp_sidecar = sidecar.with_name(f'{sidecar.name}.{os.getpid()}.tmp')
    build_cmd = [gxx, *cmd[1:]]
    build_cmd[build_cmd.index(str(so))] = str(tmp_so)
    try:
        proc = subprocess.run(build_cmd, capture_output=True, text=True, timeout=timeout)
        if proc.returncode != 0:
            raise NativeBuildError(f'g++ failed building {name} (exit {proc.returncode}):\n'
                                   f'{" ".join(build_cmd)}\n{proc.stdout}\n{proc.stderr}')
        tmp_sidecar.write_text(want)
        os.replace(tmp_so, so)
        os.replace(tmp_sidecar, sidecar)
    finally:
        tmp_so.unlink(missing_ok=True)
        tmp_sidecar.unlink(missing_ok=True)
    return so


def load(name: str, src, extra_flags=(), *, headers=()) -> ctypes.CDLL | None:
    """The helper's library, built on first use; one handle per process.
    None (after one WARNING) when the toolchain is absent, so the caller
    takes its Python path; raises NativeBuildError on a failed build or
    load."""
    with _lock:
        if name in _libs:
            return _libs[name]
        reason = missing_toolchain(headers)
        if reason is not None:
            log.warning('native %s not built (%s); using its Python fallback', name, reason)
            _status[name] = {'route': 'python', 'reason': reason}
            _libs[name] = None
            return None
        so = ensure_built(name, src, extra_flags)
        try:
            lib = ctypes.CDLL(str(so))
        except OSError as e:
            raise NativeBuildError(f'{so}: built but does not load ({e})') from e
        _status[name] = {'route': 'native', 'library': str(so)}
        _libs[name] = lib
        return lib


def status() -> dict:
    """The toolchain and the route each helper loaded so far took."""
    gxx = find_gxx()
    return {'g++': gxx, 'jpeglib.h': has_header('jpeglib.h', gxx),
            'helpers': {k: dict(v) for k, v in _status.items()}}


def reset():
    """Forget every loaded helper, so the next load() decides again."""
    with _lock:
        _libs.clear()
        _status.clear()
