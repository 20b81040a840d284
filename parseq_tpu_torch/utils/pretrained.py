"""Pretrained-weight resolution of the port: the weights table, the checksum
cache, the download and loading (counterpart of parseq_tpu/utils/pretrained.py).

Each released weight file of the reference is named
``<model>-<8-hex-sha256-prefix>.pt``, and torch.hub's ``check_hash=True``
verifies that prefix. This module keeps the table, that filename and hash
convention and the cache-directory search (torch.hub's own cache included,
so weights the reference fetched are reused). A file that is not cached is
downloaded from the table's URL into the package's cache directory when
`download_if_missing` is set (the default) and the host has a network; the
download is checked against the prefix before it takes the file's name.
Offline, or with the flag off, a missing file raises PretrainedWeightsError
naming the file and the directories searched.
"""

from __future__ import annotations

import hashlib
import os
import re
import urllib.request
from pathlib import Path

WEIGHTS_URL = {
    'parseq-tiny': 'https://github.com/baudm/parseq/releases/download/v1.0.0/parseq_tiny-e7a21b54.pt',
    'parseq-patch16-224': 'https://github.com/baudm/parseq/releases/download/v1.0.0/parseq_small_patch16_224-fcf06f5a.pt',
    'parseq': 'https://github.com/baudm/parseq/releases/download/v1.0.0/parseq-bb5792a6.pt',
    'abinet': 'https://github.com/baudm/parseq/releases/download/v1.0.0/abinet-1d1e373e.pt',
    'trba': 'https://github.com/baudm/parseq/releases/download/v1.0.0/trba-cfaed284.pt',
    'vitstr': 'https://github.com/baudm/parseq/releases/download/v1.0.0/vitstr-26d0fcf4.pt',
    'crnn': 'https://github.com/baudm/parseq/releases/download/v1.0.0/crnn-679d0e31.pt',
}

_HASH_RE = re.compile(r'-([0-9a-f]{8,})\.pt$')


class PretrainedWeightsError(RuntimeError):
    pass


def expected_filename(experiment: str) -> str:
    try:
        return WEIGHTS_URL[experiment].rsplit('/', 1)[1]
    except KeyError:
        raise PretrainedWeightsError(
            f"No pretrained weights found for '{experiment}' "
            f'(available: {sorted(WEIGHTS_URL)})') from None


def expected_hash_prefix(experiment: str) -> str:
    m = _HASH_RE.search(expected_filename(experiment))
    assert m, expected_filename(experiment)
    return m.group(1)


def cache_dirs() -> list[Path]:
    """Search order: $PARSEQ_TPU_CACHE, the package's cache, torch.hub's cache."""
    dirs = []
    if os.environ.get('PARSEQ_TPU_CACHE'):
        dirs.append(Path(os.environ['PARSEQ_TPU_CACHE']))
    home = Path(os.environ.get('XDG_CACHE_HOME') or Path.home() / '.cache')
    dirs.append(home / 'parseq_tpu' / 'checkpoints')
    dirs.append(home / 'torch' / 'hub' / 'checkpoints')
    return dirs


def sha256_prefix_ok(path, prefix: str) -> bool:
    """torch.hub check_hash semantics: the sha256 digest starts with `prefix`."""
    h = hashlib.sha256()
    with open(path, 'rb') as f:
        for chunk in iter(lambda: f.read(1 << 20), b''):
            h.update(chunk)
    return h.hexdigest().startswith(prefix)


def find_cached(experiment: str) -> Path | None:
    """The verified cached weight file for `experiment`, if any."""
    fname = expected_filename(experiment)
    prefix = expected_hash_prefix(experiment)
    for d in cache_dirs():
        cand = d / fname
        if cand.is_file():
            if sha256_prefix_ok(cand, prefix):
                return cand
            raise PretrainedWeightsError(
                f'{cand} exists but fails its sha256 check (expected prefix '
                f'{prefix}); delete it and fetch it again')
    return None


def download(experiment: str, dest_dir=None) -> Path:
    """Fetch the released weights of `experiment` into `dest_dir` (default:
    the package's cache directory). The bytes go to a `.partial` file, which
    is deleted if its sha256 does not start with the file name's prefix, and
    renamed to the file's name if it does. Needs a network (any URL scheme
    urllib reads: the tests serve `file://` URLs)."""
    fname = expected_filename(experiment)
    url = WEIGHTS_URL[experiment]
    dest_dir = Path(dest_dir) if dest_dir else cache_dirs()[-2]
    dest_dir.mkdir(parents=True, exist_ok=True)
    dest = dest_dir / fname
    tmp = dest.with_suffix('.partial')
    try:
        urllib.request.urlretrieve(url, tmp)
        if not sha256_prefix_ok(tmp, expected_hash_prefix(experiment)):
            raise PretrainedWeightsError(
                f'downloaded {url} fails its sha256 check (expected prefix '
                f'{expected_hash_prefix(experiment)})')
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    os.replace(tmp, dest)
    return dest


def get_pretrained_path(experiment: str, *, download_if_missing: bool = True) -> Path:
    """The cached, verified weight file of `experiment`; downloaded into the
    cache first when it is missing and `download_if_missing` is set. A file
    that is neither cached nor fetched raises with its name and the
    directories searched."""
    cached = find_cached(experiment)
    if cached is not None:
        return cached
    where = (f'place {expected_filename(experiment)} in one of '
             f'{[str(d) for d in cache_dirs()]}')
    if download_if_missing:
        try:
            return download(experiment)
        except OSError as e:
            raise PretrainedWeightsError(
                f"Pretrained weights for '{experiment}' not found in cache and the "
                f'download failed ({e}): {where}') from e
    raise PretrainedWeightsError(f"Pretrained weights for '{experiment}' not found in cache: "
                                 f'{where}')


def load_pretrained(experiment: str, *, download_if_missing: bool = True, **kwargs):
    """-> ModelBundle with the released weights of `experiment`, built from
    the experiment's config (so parseq-tiny gets its 192-dim geometry);
    `download_if_missing` as for get_pretrained_path, other keyword
    arguments as for `registry.load_from_checkpoint`."""
    import torch

    from parseq_tpu_torch.utils.registry import _from_reference

    path = get_pretrained_path(experiment, download_if_missing=download_if_missing)
    obj = torch.load(path, map_location='cpu', weights_only=True)
    return _from_reference(obj, experiment, **kwargs)
