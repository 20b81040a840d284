"""LMDB-backed scene-text datasets + a multiprocess host loader.

Behavioral parity with the reference data layer
(strhub/data/dataset.py:32-148): recursive ``**/data.mdb``
scan, per-record label preprocessing (whitespace strip, NFKD unicode->ASCII,
max-length filter BEFORE charset stripping, empty-label and min-image-dim
filters), lazy JPEG/PNG decode at access time.

TPU-first differences:
  * Our own LMDB reader (parseq_tpu_torch.data.lmdb) — no liblmdb dependency.
  * The loader produces fixed-shape NHWC float32 batches (drop_last on train,
    zero-padded final batch + valid mask on eval) ready for device transfer;
    decode/augment runs in a worker pool that prefetches ahead of the device.
"""

from __future__ import annotations

import glob
import io
import logging
import unicodedata
from pathlib import Path

import numpy as np
from PIL import Image

from parseq_tpu_torch.data.charset import CharsetAdapter
from parseq_tpu_torch.data.lmdb import open_reader

log = logging.getLogger(__name__)


class LmdbDataset:
    """Random access to one LMDB scene-text database (image, label) pairs."""

    def __init__(self, root, charset, max_label_len, min_image_dim=0,
                 remove_whitespace=True, normalize_unicode=True,
                 unlabelled=False, transform=None):
        self.root = str(root)
        self.unlabelled = unlabelled
        self.transform = transform
        self._reader = None
        self.labels = []
        self.filtered_index_list = []
        self.num_samples = self._preprocess_labels(
            charset, remove_whitespace, normalize_unicode, max_label_len, min_image_dim
        )

    # Lazy per-process open: safe after fork into loader workers.
    @property
    def reader(self):
        if self._reader is None:
            self._reader = open_reader(self.root)
        return self._reader

    def __getstate__(self):
        state = self.__dict__.copy()
        state['_reader'] = None
        return state

    def _preprocess_labels(self, charset, remove_whitespace, normalize_unicode,
                           max_label_len, min_image_dim):
        charset_adapter = CharsetAdapter(charset)
        with open_reader(self.root) as rd:
            num_samples = int(rd.get(b'num-samples'))
            if self.unlabelled:
                return num_samples
            for index in range(1, num_samples + 1):
                raw = rd.get(f'label-{index:09d}'.encode())
                if raw is None:
                    continue
                label = raw.decode()
                if remove_whitespace:
                    label = ''.join(label.split())
                if normalize_unicode:
                    label = unicodedata.normalize('NFKD', label).encode('ascii', 'ignore').decode()
                # Length filter BEFORE charset stripping (the original label
                # might be too long even if the stripped one is not).
                if len(label) > max_label_len:
                    continue
                label = charset_adapter(label)
                if not label:
                    continue
                if min_image_dim > 0:
                    buf = rd.get(f'image-{index:09d}'.encode())
                    w, h = Image.open(io.BytesIO(buf)).size
                    if w < min_image_dim or h < min_image_dim:
                        continue
                self.labels.append(label)
                self.filtered_index_list.append(index)
        return len(self.labels)

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index):
        if self.unlabelled:
            label = index
        else:
            label = self.labels[index]
            index = self.filtered_index_list[index]
        buf = self.reader.get(f'image-{index:09d}'.encode())
        if self.transform is not None:
            if getattr(self.transform, 'accepts_bytes', False):
                # decode inside the transform: enables real DCT-scaled
                # (draft) decoding — an up-front convert('RGB') here would
                # force a full decode
                return self.transform(buf), label
            img = Image.open(io.BytesIO(buf)).convert('RGB')
            return self.transform(img), label
        return Image.open(io.BytesIO(buf)).convert('RGB'), label


class ConcatDataset:
    def __init__(self, datasets):
        self.datasets = list(datasets)
        self._offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self._offsets[-1])

    def __getitem__(self, index):
        d = int(np.searchsorted(self._offsets, index, side='right')) - 1
        return self.datasets[d][index - self._offsets[d]]


def build_tree_dataset(root, *args, **kwargs):
    root = Path(root).absolute()
    log.info(f'dataset root:\t{root}')
    datasets = []
    for mdb in sorted(glob.glob(str(root / '**/data.mdb'), recursive=True)):
        mdb = Path(mdb)
        ds = LmdbDataset(str(mdb.parent), *args, **kwargs)
        log.info(f'\tlmdb:\t{mdb.parent.relative_to(root)}\tnum samples: {len(ds)}')
        datasets.append(ds)
    return ConcatDataset(datasets)
