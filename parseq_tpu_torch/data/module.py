"""SceneTextDataModule equivalent: dataset construction + loaders.

Mirrors strhub/data/module.py:27-157 (benchmark-set
constants, transform pipeline, train/val/test loader construction) on top of
the port's LMDB reader and host loader.
"""

from __future__ import annotations

from pathlib import PurePath

from parseq_tpu_torch.data.dataset import LmdbDataset, build_tree_dataset
from parseq_tpu_torch.data.loader import DataLoader
from parseq_tpu_torch.data.transforms import preprocess_pil, preprocess_pil_u8

TEST_BENCHMARK_SUB = ('IIIT5k', 'SVT', 'IC13_857', 'IC15_1811', 'SVTP', 'CUTE80')
TEST_BENCHMARK = ('IIIT5k', 'SVT', 'IC13_1015', 'IC15_2077', 'SVTP', 'CUTE80')
TEST_NEW = ('ArT', 'COCOv1.4', 'Uber')
TEST_ALL = tuple(set(TEST_BENCHMARK_SUB + TEST_BENCHMARK + TEST_NEW))


def get_transform(img_size, augment=False, rotation=0, u8=False):
    """PIL image OR raw encoded bytes -> model input, reference pipeline order.

    ``u8=True``: return resized uint8 instead of f32 and let the device do the
    identical normalize (train/steps.py:normalize_u8) — 4x less loader IPC
    and H2D traffic. Datasets pass RAW BYTES (transform.accepts_bytes) so
    decode happens inside the transform: on the eval u8 path a JPEG goes
    through the native fused decode+resize (data/native/jpeg_decode.cpp,
    bit-identical to the PIL path), with augmentation through the native
    full-resolution decode; anything else (PNG, CMYK, no native decoder)
    through PIL, where ``draft`` engages.
    """
    aug = None
    if augment:
        from parseq_tpu_torch.data.augment import rand_augment_transform

        aug = rand_augment_transform()

    def transform(img):
        if isinstance(img, (bytes, memoryview)):
            from parseq_tpu_torch.data.native import jpeg_decode, jpeg_decode_resize

            if u8 and aug is None and rotation == 0:
                arr = jpeg_decode_resize(img, img_size)
                if arr is not None:
                    return arr
            import io

            from PIL import Image

            if aug is not None:
                # augment needs the full-resolution RGB image (reference
                # transform order, module.py:68-82)
                arr = jpeg_decode(img)
                img = (Image.fromarray(arr) if arr is not None
                       else Image.open(io.BytesIO(bytes(img))).convert('RGB'))
            else:
                img = Image.open(io.BytesIO(bytes(img)))
        if aug is not None:
            img = aug(img)
        if u8:
            return preprocess_pil_u8(img, img_size, rotation)
        return preprocess_pil(img, img_size, rotation)

    transform.accepts_bytes = True
    return transform


class SceneTextDataModule:

    def __init__(self, root_dir, train_dir, img_size, max_label_length,
                 charset_train, charset_test, batch_size, num_workers=2,
                 augment=True, remove_whitespace=True, normalize_unicode=True,
                 min_image_dim=0, rotation=0):
        self.root_dir = root_dir
        self.train_dir = train_dir
        self.img_size = tuple(img_size)
        self.max_label_length = max_label_length
        self.charset_train = charset_train
        self.charset_test = charset_test
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.augment = augment
        self.remove_whitespace = remove_whitespace
        self.normalize_unicode = normalize_unicode
        self.min_image_dim = min_image_dim
        self.rotation = rotation
        self._train_dataset = None
        self._val_dataset = None

    @property
    def train_dataset(self):
        if self._train_dataset is None:
            self._train_dataset = build_tree_dataset(
                PurePath(self.root_dir, 'train', self.train_dir),
                self.charset_train, self.max_label_length, self.min_image_dim,
                self.remove_whitespace, self.normalize_unicode,
                # u8 transport is the production default (4x less worker IPC
                # + H2D; in-jit normalize is bit-identical to f32 transport —
                # steps.normalize_u8). An end-of-round-4 snapshot accidentally
                # reverted this to u8=False; restored + re-validated in round 5
                # (loader-fed E2E + production-config full-workflow run,
                # PERF.md "Training data path").
                transform=get_transform(self.img_size, self.augment, u8=True),
            )
        return self._train_dataset

    @property
    def val_dataset(self):
        if self._val_dataset is None:
            self._val_dataset = build_tree_dataset(
                PurePath(self.root_dir, 'val'),
                self.charset_test, self.max_label_length, self.min_image_dim,
                self.remove_whitespace, self.normalize_unicode,
                transform=get_transform(self.img_size, u8=True),
            )
        return self._val_dataset

    def train_dataloader(self, seed=0, shard_rank=0, shard_count=1, microbatches=1):
        """batch_size is the GLOBAL batch; on several ranks each passes its
        (rank, count) and the step's microbatch count, and receives its
        share of each global microbatch (loader.shard_positions)."""
        return DataLoader(self.train_dataset, self.batch_size, shuffle=True,
                          drop_last=True, num_workers=self.num_workers, seed=seed,
                          shard_rank=shard_rank, shard_count=shard_count,
                          microbatches=microbatches)

    def val_dataloader(self):
        return DataLoader(self.val_dataset, self.batch_size, num_workers=self.num_workers)

    def test_dataloaders(self, subset, u8=True):
        transform = get_transform(self.img_size, rotation=self.rotation, u8=u8)
        root = PurePath(self.root_dir, 'test')
        return {
            s: DataLoader(
                LmdbDataset(str(root / s), self.charset_test, self.max_label_length,
                            self.min_image_dim, self.remove_whitespace,
                            self.normalize_unicode, transform=transform),
                self.batch_size, num_workers=self.num_workers,
            )
            for s in subset
        }
