"""Datasets and batching.

Mirrors vit_pruning_tpu/data/datasets.py. The loaders and the synthetic
tasks are plain numpy and the same code as the reference's: their arrays are
byte-identical to the JAX package's for the same arguments (the tests hold
them so).

  * `load_cifar100`     — the standard CIFAR-100 python-pickle layout from a
                          local directory; no network.
  * `load_image_folder` — class-per-subdirectory trees (TinyImageNet /
                          ImageNet-val) decoded with PIL, resized by the port's
                          native PIL-bit-exact resampler.
  * `synthetic_*`       — deterministic tasks for tests, the CLI and the
                          quality gates.

`Batches` is the DataLoader role (a seeded, epoch-pinned shuffle, a fixed
batch size, drop_last) with preprocessing on `device` (the card unless the
caller asks for the CPU): each batch's uint8 images are copied there and
preprocessed by data/preprocess.py::vit_preprocess. `DeviceBatches` uploads
the whole uint8 dataset once and gathers each batch there with an index
tensor; `PrefetchBatches` runs any batcher's host work in a worker thread
ahead of the training step. Batches are {'pixel_values': [B, 3, S, S]
float32, 'labels': [B] int64}.
"""

from __future__ import annotations

import os
import pickle
import tarfile
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from vit_pruning_tpu_torch.data.preprocess import vit_preprocess
from vit_pruning_tpu_torch.models.convert import check_device


def load_cifar100(
    root: str, train: bool = True, size: Optional[int] = None, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-100 from the standard `cifar-100-python` pickle layout.

    Returns (images [N, 32, 32, 3] uint8, labels [N] int32). `size` takes a
    seeded random subset (the reference's randperm subset,
    main_model_utils.py:45-47).
    """
    base = os.path.join(root, "cifar-100-python")
    if not os.path.isdir(base):
        tgz = os.path.join(root, "cifar-100-python.tar.gz")
        if os.path.isfile(tgz):
            with tarfile.open(tgz) as tf:
                tf.extractall(root, filter="data")
        else:
            raise FileNotFoundError(
                f"CIFAR-100 not found under {root!r} (expected cifar-100-python/ "
                "or cifar-100-python.tar.gz; this environment cannot download)"
            )
    fname = os.path.join(base, "train" if train else "test")
    with open(fname, "rb") as f:
        d = pickle.load(f, encoding="bytes")
    images = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    labels = np.asarray(d[b"fine_labels"], dtype=np.int32)
    if size is not None:
        idx = np.random.RandomState(seed).permutation(len(labels))[:size]
        images, labels = images[idx], labels[idx]
    return images, labels


def load_image_folder(
    root: str,
    split: Optional[str] = None,
    size: Optional[int] = None,
    image_size: int = 224,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray]:
    """class-per-subdirectory image tree -> (images [N,H,W,3] uint8, labels).

    Images are decoded host-side with PIL and resized with the bit-exact
    native C++ resampler when the decoded sizes are uniform (TinyImageNet:
    64x64) — one multithreaded batch call instead of N Python-loop resizes —
    falling back to per-image PIL bilinear (the HF processor's resample)
    otherwise. Matches TinyImageNetDataset semantics
    (main_model_utils.py:64-95).
    """
    from PIL import Image

    folder = os.path.join(root, split) if split else root
    classes = sorted(
        d for d in os.listdir(folder) if os.path.isdir(os.path.join(folder, d))
    )
    files, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(folder, cname)
        for dirpath, _, fnames in os.walk(cdir):
            for fn in sorted(fnames):
                if fn.lower().endswith((".jpg", ".jpeg", ".png", ".bmp")):
                    files.append(os.path.join(dirpath, fn))
                    labels.append(ci)
    labels = np.asarray(labels, dtype=np.int32)
    if size is not None:
        idx = np.random.RandomState(seed).permutation(len(labels))[:size]
        files = [files[i] for i in idx]
        labels = labels[idx]
    from vit_pruning_tpu_torch import native

    # decode + resize in bounded chunks: a chunk of same-shape decodes goes
    # through the native batch resampler in one call; mixed shapes fall back
    # to per-image PIL. Peak host memory is one chunk of full-size decodes
    # (not the whole tree), so arbitrary-size image folders stay safe.
    chunk_size = 256
    out = np.empty((len(files), image_size, image_size, 3), np.uint8)
    use_native = native.available()
    for lo in range(0, len(files), chunk_size):
        decoded = [
            np.asarray(Image.open(f).convert("RGB"), dtype=np.uint8)
            for f in files[lo : lo + chunk_size]
        ]
        if use_native and decoded and len({im.shape for im in decoded}) == 1:
            out[lo : lo + len(decoded)] = native.resize_bilinear(
                np.stack(decoded), image_size, image_size
            )
        else:
            for i, im in enumerate(decoded):
                out[lo + i] = np.asarray(
                    Image.fromarray(im).resize(
                        (image_size, image_size), Image.BILINEAR
                    ),
                    dtype=np.uint8,
                )
    return out, labels


def synthetic_localized_dataset(
    n: int,
    image_size: int = 32,
    num_labels: int = 128,
    seed: int = 0,
    class_seed: int = 1234,
    label_noise: float = 0.1,
    signal_patches: int = 8,
    cell: int = 4,
) -> Tuple[np.ndarray, np.ndarray]:
    """A NON-saturating synthetic classification task for the quality gate.

    Design goals (VERDICT r1: a delta gate at the accuracy ceiling can't
    fail): (1) many classes + irreducible label noise => the dense model
    converges strictly below 100% (ceiling ~= 1 - noise + noise/C); (2) the
    class evidence lives in a few class-specific PATCH cells on a noise
    background, so token skipping is a real subproblem — pruning the wrong
    patches destroys accuracy, making the gate sensitive to predictor
    quality rather than vacuously PASS.

    Labels are noisy in both splits (same rate), so dense and pruned models
    converge to the same noise-limited cap and the delta isolates pruning
    damage. Deterministic: class prototypes/positions depend only on
    class_seed; sampling on seed.

    The background is SMOOTH (a per-image low-frequency gradient plus small
    noise), not iid pixel noise: like a real photo, background tokens pass
    through layers nearly unchanged (high oracle similarity — predictably
    skippable) while the high-contrast evidence cells change a lot. An
    iid-noise background makes the oracle similarity distribution unimodal,
    which turns the threshold-median oracle labels into coin flips and caps
    predictor-vs-oracle accuracy near 55% regardless of predictor quality.
    """
    rng = np.random.RandomState(seed)
    proto = np.random.RandomState(class_seed)
    g = image_size // cell
    # class-specific signal cells and patterns
    cells_per_class = np.stack([
        proto.choice(g * g, size=signal_patches, replace=False)
        for _ in range(num_labels)
    ])  # [C, P]
    patterns = proto.rand(num_labels, signal_patches, cell, cell, 3)  # in [0,1]

    true_labels = rng.randint(0, num_labels, n).astype(np.int32)
    # smooth background: bilinear ramp between four per-image corner colors
    yy = np.linspace(0.0, 1.0, image_size, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0.0, 1.0, image_size, dtype=np.float32)[None, None, :, None]
    c00, c01, c10, c11 = (rng.rand(4, n, 1, 1, 3).astype(np.float32) * 0.8)
    images = ((1 - yy) * (1 - xx) * c00 + (1 - yy) * xx * c01
              + yy * (1 - xx) * c10 + yy * xx * c11
              + 0.05 * rng.rand(n, image_size, image_size, 3)).astype(np.float32)
    for i in range(n):
        c = true_labels[i]
        for p in range(signal_patches):
            r, q = divmod(int(cells_per_class[c, p]), g)
            images[i, r * cell:(r + 1) * cell, q * cell:(q + 1) * cell] = (
                0.25 * images[i, r * cell:(r + 1) * cell, q * cell:(q + 1) * cell]
                + 0.75 * patterns[c, p]
            )
    labels = true_labels.copy()
    flip = rng.rand(n) < label_noise
    labels[flip] = rng.randint(0, num_labels, int(flip.sum())).astype(np.int32)
    return (images * 255).astype(np.uint8), labels


def synthetic_distributed_dataset(
    n: int,
    image_size: int = 32,
    num_labels: int = 128,
    seed: int = 0,
    class_seed: int = 1234,
    label_noise: float = 0.1,
    signal_patches: int = 8,
    cell: int = 4,
    vocab: int = 2,
) -> Tuple[np.ndarray, np.ndarray]:
    """The DISTRIBUTED-evidence counterpart of `synthetic_localized_dataset`
    — built so a depth sweep of the accuracy gate can actually fail.

    In the localized task every (class, cell) pattern is unique, so ONE kept
    evidence patch identifies the class and the delta gate measures 0.0 at
    every budget (quality_results.json::deit_small_224.gate_margin,
    gate_can_fail=false through 98% skip — measured). Here the class is a
    CODEWORD: all classes share the same `signal_patches` cell positions and
    each cell shows one of `vocab` cell-specific patterns; the class is the
    combination (an injective map class -> vocab^P). A single cell narrows
    the label to ~num_labels/vocab candidates, so identification needs
    ~log(num_labels)/log(vocab) cells kept THROUGH the drop layer — token
    budgets below that integration threshold lose real information no
    predictor can recover, which is what deep skipping costs on natural
    images (the reference never charges for this because its datasets are
    object-centric; cf. the ImageNet 82.45->80.16 drop it ships,
    BASELINE.md). Default vocab=2, P=8: needs ~7 of 8 evidence cells —
    the gate fails between top_k=9 and top_k=6 at DeiT-S/224 geometry.

    Same smooth background + irreducible label noise as the localized task
    (the oracle-similarity structure predictors train on is unchanged).
    """
    if num_labels > vocab ** signal_patches:
        raise ValueError(
            f"{num_labels} classes need > vocab**signal_patches "
            f"({vocab}**{signal_patches}) codewords")
    rng = np.random.RandomState(seed)
    proto = np.random.RandomState(class_seed)
    g = image_size // cell
    # shared evidence positions; per-cell pattern banks; injective codewords
    cells = proto.choice(g * g, size=signal_patches, replace=False)  # [P]
    bank = proto.rand(signal_patches, vocab, cell, cell, 3)  # [P, V, c, c, 3]
    chosen = proto.choice(vocab ** signal_patches, size=num_labels,
                          replace=False)
    codes = np.stack(
        np.unravel_index(chosen, [vocab] * signal_patches), axis=1
    )  # [C, P] in [0, vocab)

    true_labels = rng.randint(0, num_labels, n).astype(np.int32)
    yy = np.linspace(0.0, 1.0, image_size, dtype=np.float32)[None, :, None, None]
    xx = np.linspace(0.0, 1.0, image_size, dtype=np.float32)[None, None, :, None]
    c00, c01, c10, c11 = (rng.rand(4, n, 1, 1, 3).astype(np.float32) * 0.8)
    images = ((1 - yy) * (1 - xx) * c00 + (1 - yy) * xx * c01
              + yy * (1 - xx) * c10 + yy * xx * c11
              + 0.05 * rng.rand(n, image_size, image_size, 3)).astype(np.float32)
    for i in range(n):
        code = codes[true_labels[i]]
        for p in range(signal_patches):
            r, q = divmod(int(cells[p]), g)
            images[i, r * cell:(r + 1) * cell, q * cell:(q + 1) * cell] = (
                0.25 * images[i, r * cell:(r + 1) * cell, q * cell:(q + 1) * cell]
                + 0.75 * bank[p, code[p]]
            )
    labels = true_labels.copy()
    flip = rng.rand(n) < label_noise
    labels[flip] = rng.randint(0, num_labels, int(flip.sum())).astype(np.int32)
    return (images * 255).astype(np.uint8), labels


def synthetic_dataset(
    n: int = 256,
    image_size: int = 32,
    num_labels: int = 10,
    seed: int = 0,
    noise: float = 0.3,
    class_seed: int = 1234,
) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic fake data (class-dependent pattern + noise) so tiny
    training runs can actually learn something in tests.

    class_seed fixes the class prototypes independently of `seed`, so train
    and test splits (different seeds) share the same classes.
    """
    rng = np.random.RandomState(seed)
    proto_rng = np.random.RandomState(class_seed)
    labels = rng.randint(0, num_labels, n).astype(np.int32)
    base = proto_rng.rand(num_labels, image_size, image_size, 3) * 255
    images = base[labels] * (1 - noise) + rng.rand(n, image_size, image_size, 3) * noise * 255
    return images.astype(np.uint8), labels


class Batches:
    """Host batcher with preprocessing on `device`.

    Yields dicts {'pixel_values': [B,3,S,S] float32, 'labels': [B] int64},
    both on `device`. drop_last=True keeps every batch the same shape.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        image_size: int = 224,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = True,
        device="cuda",
    ):
        if len(images) < batch_size:
            raise ValueError(
                f"dataset of {len(images)} samples smaller than batch_size {batch_size}"
            )
        self.device = check_device(device)
        self.images = images
        self.labels = labels
        self._num_images = len(images)
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self._epoch = 0

    def __len__(self) -> int:
        n = self._num_images // self.batch_size
        if not self.drop_last and self._num_images % self.batch_size:
            n += 1
        return n

    @property
    def num_samples(self) -> int:
        return len(self) * self.batch_size if self.drop_last else self._num_images

    def set_epoch(self, epoch: int):
        """Pin the shuffle order to an epoch index (exact training resume)."""
        self._epoch = epoch

    def _batch_indices(self) -> Iterator[np.ndarray]:
        """Epoch-pinned iteration order — the single definition of batch
        order/reshuffle semantics, shared by every batcher subclass."""
        order = np.arange(self._num_images)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self._epoch).permutation(order)
            self._epoch += 1
        for i in range(len(self)):
            yield order[i * self.batch_size : (i + 1) * self.batch_size]

    def __iter__(self) -> Iterator[dict]:
        for idx in self._batch_indices():
            images = torch.from_numpy(np.ascontiguousarray(self.images[idx]))
            yield {
                "pixel_values": vit_preprocess(images.to(self.device, non_blocking=True),
                                               self.image_size),
                "labels": torch.from_numpy(self.labels[idx].astype(np.int64)).to(self.device),
            }


class DeviceBatches(Batches):
    """Batches with the WHOLE uint8 dataset resident on `device`.

    The images are uploaded once; each batch is gathered there with an
    index tensor (torch.index_select) and preprocessed there, so no batch
    crosses the host link. Uint8 images fit in the card's memory at every
    gate scale (8192 x 224^2 x 3 = 1.2 GB). Identical batch order and
    semantics to Batches (the same epoch-pinned shuffle). The host copies
    are dropped once uploaded."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self._dev_images = torch.from_numpy(np.ascontiguousarray(self.images)).to(self.device)
        self._dev_labels = torch.from_numpy(np.asarray(self.labels).astype(np.int64)).to(
            self.device)
        self.images = None
        self.labels = None

    def __iter__(self) -> Iterator[dict]:
        for idx in self._batch_indices():
            i = torch.from_numpy(idx).to(self.device, non_blocking=True)
            yield {
                "pixel_values": vit_preprocess(self._dev_images.index_select(0, i),
                                               self.image_size),
                "labels": self._dev_labels.index_select(0, i),
            }


class PrefetchBatches:
    """Asynchronous prefetch over any batch iterable.

    The counterpart of the reference's input parallelism
    (`DataLoader(num_workers=16, pin_memory=True)`, himanshu/hi_main.py:150-151):
    a worker thread runs the wrapped iterable's host work (index gather,
    decode, the host-to-device copy and the preprocess launch) `depth`
    batches ahead of the training step, so the host pipeline overlaps device
    compute instead of serialising with it.

    Use when the dataset does NOT fit on the card (else prefer
    DeviceBatches, which uploads once). Wraps Batches/DeviceBatches or any
    iterable of batch dicts; len/num_samples/set_epoch delegate when present.

    depth=2 double-buffers: one batch in flight, one queued. Exceptions in
    the worker (e.g. a decode error) re-raise at the consuming step, not
    silently. Each `iter()` drains through a fresh worker; abandoning the
    iterator (exception, early break, generator GC) signals the worker via
    a stop event in the generator's `finally`, so it exits promptly instead
    of blocking on the full queue and pinning `depth` batches on the card
    for the process lifetime.
    """

    def __init__(self, inner, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self.inner = inner
        self.depth = depth

    def __len__(self) -> int:
        return len(self.inner)

    @property
    def num_samples(self) -> int:
        return self.inner.num_samples

    def set_epoch(self, epoch: int):
        # delegate when present: a plain iterable of batch dicts has no
        # epoch-pinned shuffle to re-seed, and the harness's
        # hasattr(train_batches, 'set_epoch') guard sees this method on the
        # wrapper regardless of the inner's type
        if hasattr(self.inner, "set_epoch"):
            self.inner.set_epoch(epoch)

    def __iter__(self) -> Iterator[dict]:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        _END = object()
        stop = threading.Event()

        def put(item) -> bool:
            """Blocking put that aborts when the consumer is gone."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            try:
                for batch in self.inner:
                    if not put(batch):
                        return
                put(_END)
            except BaseException as e:  # propagate to the consumer
                put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
