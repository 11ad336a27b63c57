"""The port's data pipeline (vit_pruning_tpu_torch/data) against the JAX
package's: the synthetic tasks and the local loaders byte-equal, the batch
order equal across epochs, the device and prefetch batchers equal to
Batches, vit_preprocess against jax.image.resize within 5e-3 on the 0..255
scale (4e-5 after normalisation) on downscales and upscales, pil_preprocess
bit-equal, and the fetchers' offline behaviour."""

import os
import pickle
import tarfile

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from vit_pruning_tpu.data import datasets as jd
from vit_pruning_tpu.data.preprocess import pil_preprocess as j_pil
from vit_pruning_tpu.data.preprocess import vit_preprocess as j_vit_preprocess
from vit_pruning_tpu_torch.data import datasets as td
from vit_pruning_tpu_torch.data.preprocess import pil_preprocess, vit_preprocess

# 5e-3 on the 0..255 scale, after the (x / 255 - 0.5) / 0.5 normalisation
PRE_TOL = 5e-3 / 127.5


@pytest.mark.parametrize("fn,kw", [
    ("synthetic_dataset", dict(n=40, image_size=16, num_labels=4, seed=3)),
    ("synthetic_dataset", dict(n=17, image_size=32, num_labels=10, seed=0, noise=0.5)),
    ("synthetic_localized_dataset", dict(n=24, image_size=32, num_labels=16, seed=1)),
    ("synthetic_localized_dataset", dict(n=9, image_size=64, num_labels=8, seed=2,
                                         signal_patches=16, cell=16, label_noise=0.3)),
    ("synthetic_distributed_dataset", dict(n=24, image_size=32, num_labels=64, seed=0)),
    ("synthetic_distributed_dataset", dict(n=12, image_size=32, num_labels=20, seed=5,
                                           vocab=3, signal_patches=4, label_noise=0.0)),
])
def test_synthetic_datasets_byte_equal(fn, kw):
    ti, tl = getattr(td, fn)(**kw)
    ji, jl = getattr(jd, fn)(**kw)
    assert ti.dtype == ji.dtype == np.uint8 and tl.dtype == jl.dtype
    assert ti.tobytes() == ji.tobytes() and tl.tobytes() == jl.tobytes()


def test_distributed_dataset_refuses_too_many_classes():
    with pytest.raises(ValueError):
        td.synthetic_distributed_dataset(8, num_labels=300, vocab=2, signal_patches=8)


def _write_cifar(root, n_train=20, n_test=12, tar=False):
    rs = np.random.RandomState(7)
    base = os.path.join(root, "cifar-100-python")
    os.makedirs(base)
    for split, n in (("train", n_train), ("test", n_test)):
        d = {b"data": rs.randint(0, 256, (n, 3 * 32 * 32)).astype(np.uint8),
             b"fine_labels": list(rs.randint(0, 100, n))}
        with open(os.path.join(base, split), "wb") as f:
            pickle.dump(d, f)
    if tar:
        with tarfile.open(os.path.join(root, "cifar-100-python.tar.gz"), "w:gz") as tf:
            tf.add(base, arcname="cifar-100-python")
        import shutil

        shutil.rmtree(base)


@pytest.mark.parametrize("tar", [False, True])
def test_load_cifar100_equal(tmp_path, tar):
    for sub in ("t", "j"):
        _write_cifar(str(tmp_path / sub), tar=tar)
    for train in (True, False):
        for size in (None, 5):
            ti, tl = td.load_cifar100(str(tmp_path / "t"), train=train, size=size)
            ji, jl = jd.load_cifar100(str(tmp_path / "j"), train=train, size=size)
            assert ti.shape[1:] == (32, 32, 3)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)
    with pytest.raises(FileNotFoundError, match="cannot download"):
        td.load_cifar100(str(tmp_path / "missing"))


def test_load_image_folder_equal(tmp_path):
    """Uniform decodes (the native batch resampler) and mixed sizes (the PIL
    loop) give the reference's arrays."""
    from PIL import Image

    rs = np.random.RandomState(3)
    for split, shapes in (("train", [(40, 40)] * 3), ("val", [(40, 40), (30, 50), (64, 20)])):
        for ci, cname in enumerate(("cat", "dog")):
            d = tmp_path / split / cname
            d.mkdir(parents=True)
            for k, (h, w) in enumerate(shapes):
                Image.fromarray(rs.randint(0, 256, (h, w, 3), np.uint8)).save(d / f"{k}.png")
    for split in ("train", "val"):
        for size in (None, 4):
            ti, tl = td.load_image_folder(str(tmp_path), split, size=size, image_size=24)
            ji, jl = jd.load_image_folder(str(tmp_path), split, size=size, image_size=24)
            assert ti.shape[1:] == (24, 24, 3)
            np.testing.assert_array_equal(ti, ji)
            np.testing.assert_array_equal(tl, jl)


@pytest.mark.parametrize("in_hw,size", [
    ((224, 224), 96),   # downscale (antialiased in the reference)
    ((300, 300), 224),  # downscale at a non-integer ratio
    ((32, 32), 224),    # CIFAR upscale, 7x
    ((37, 37), 224),    # upscale at a non-integer ratio
    ((50, 70), 64),     # one axis up, one down
    ((16, 16), 16),     # no resize
])
def test_vit_preprocess_against_jax(in_hw, size):
    rs = np.random.RandomState(sum(in_hw) + size)
    ims = rs.randint(0, 256, (2, *in_hw, 3), np.uint8)
    got = vit_preprocess(torch.from_numpy(ims), size)
    ref = np.asarray(j_vit_preprocess(jnp.asarray(ims), size))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape == (2, 3, size, size)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=PRE_TOL)
    # float input on the 0..255 scale takes the same path
    np.testing.assert_allclose(vit_preprocess(torch.from_numpy(ims).float(), size).numpy(),
                               got.numpy(), rtol=0, atol=0)


def test_pil_preprocess_bit_equal():
    rs = np.random.RandomState(1)
    ims = rs.randint(0, 256, (3, 32, 32, 3), np.uint8)
    for force in (False, True):
        np.testing.assert_array_equal(pil_preprocess(list(ims), size=48, _force_pil=force),
                                      j_pil(list(ims), size=48, _force_pil=force))
    mixed = [rs.randint(0, 256, (20, 30, 3), np.uint8), rs.randint(0, 256, (32, 32, 3), np.uint8)]
    np.testing.assert_array_equal(pil_preprocess(mixed, size=40), j_pil(mixed, size=40))


def _batches_equal(a_list, b_list, atol=0.0):
    assert len(a_list) == len(b_list)
    for a, b in zip(a_list, b_list):
        np.testing.assert_allclose(np.asarray(a["pixel_values"]), np.asarray(b["pixel_values"]),
                                   rtol=0, atol=atol)
        np.testing.assert_array_equal(np.asarray(a["labels"]), np.asarray(b["labels"]))


@pytest.mark.parametrize("shuffle,drop_last,image_size", [
    (True, True, 16), (False, True, 16), (True, False, 24), (False, False, 12)])
def test_batches_order_equal_across_epochs(shuffle, drop_last, image_size):
    """The same epoch-pinned order as the reference (RandomState(seed +
    epoch)), epoch after epoch and after set_epoch; pixel values within the
    preprocess tolerance, labels equal."""
    images, labels = td.synthetic_dataset(n=70, image_size=16, num_labels=4)
    kw = dict(batch_size=16, image_size=image_size, shuffle=shuffle, seed=3,
              drop_last=drop_last)
    tb, jb = td.Batches(images, labels, device="cpu", **kw), jd.Batches(images, labels, **kw)
    assert len(tb) == len(jb) and tb.num_samples == jb.num_samples
    for _ in range(3):
        _batches_equal(list(tb), list(jb), atol=PRE_TOL)
    tb.set_epoch(7), jb.set_epoch(7)
    t7 = list(tb)
    _batches_equal(t7, list(jb), atol=PRE_TOL)
    assert t7[0]["labels"].dtype == torch.int64 and t7[0]["pixel_values"].device.type == "cpu"
    if shuffle:
        assert not np.array_equal(np.asarray(t7[0]["labels"]), np.asarray(list(tb)[0]["labels"]))


def test_batches_reject_tiny_dataset_and_default_to_the_card(monkeypatch):
    images, labels = td.synthetic_dataset(n=8, image_size=16)
    with pytest.raises(ValueError):
        td.Batches(images, labels, batch_size=32, image_size=16, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        td.Batches(images, labels, batch_size=4, image_size=16)


def test_device_batches_equal_batches():
    images, labels = td.synthetic_dataset(n=40, image_size=16, num_labels=4)
    kw = dict(batch_size=8, image_size=20, shuffle=True, seed=3, device="cpu")
    hb, db = td.Batches(images, labels, **kw), td.DeviceBatches(images, labels, **kw)
    assert db.images is None and db.labels is None  # host copies dropped once uploaded
    for epoch in (1, 2):
        hb.set_epoch(epoch), db.set_epoch(epoch)
        _batches_equal(list(db), list(hb))


def test_prefetch_batches_equal_inner_and_delegate():
    images, labels = td.synthetic_dataset(n=64, image_size=16, num_labels=4)
    kw = dict(batch_size=16, image_size=16, shuffle=True, seed=3, device="cpu")
    inner = td.Batches(images, labels, **kw)
    pre = td.PrefetchBatches(td.DeviceBatches(images, labels, **kw), depth=2)
    inner.set_epoch(2), pre.set_epoch(2)
    assert len(pre) == len(inner) and pre.num_samples == inner.num_samples
    _batches_equal(list(pre), list(inner))
    td.PrefetchBatches([{"x": 1}]).set_epoch(3)  # a plain iterable: nothing to delegate to


def test_prefetch_batches_propagate_worker_errors_and_reject_bad_depth():
    class Boom:
        def __iter__(self):
            yield {"labels": torch.zeros(2)}
            raise RuntimeError("decode failed")

    it = iter(td.PrefetchBatches(Boom(), depth=1))
    next(it)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)
    with pytest.raises(ValueError):
        td.PrefetchBatches(Boom(), depth=0)


def test_prefetch_batches_abandoned_iterator_releases_worker():
    import threading
    import time

    before = threading.active_count()
    it = iter(td.PrefetchBatches([{"x": i} for i in range(100)], depth=1))
    assert next(it)["x"] == 0
    it.close()  # abandon mid-epoch -> finally -> stop.set()
    deadline = time.time() + 5.0
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before, "prefetch worker did not exit"


def test_fetch_offline_error_and_marker(tmp_path, monkeypatch):
    """Without the kaggle packages the fetchers raise with the remedy (the
    JAX package's wording); a completed-fetch marker short-circuits."""
    import sys

    from vit_pruning_tpu.data import fetch as jfetch
    from vit_pruning_tpu_torch.data import fetch

    monkeypatch.setitem(sys.modules, "kaggle", None)
    monkeypatch.setitem(sys.modules, "kagglehub", None)
    msgs = []
    for mod in (fetch, jfetch):
        for fn, dest in (("fetch_imagenet_val", "inval"), ("fetch_tiny_imagenet", "tiny")):
            with pytest.raises(RuntimeError) as e:
                getattr(mod, fn)(str(tmp_path / dest))
            msgs.append(str(e.value))
    assert msgs[:2] == msgs[2:] and "kaggle" in msgs[0] and "kagglehub" in msgs[1]
    assert (fetch.KAGGLE_IMAGENET_VAL, fetch.KAGGLEHUB_TINY_IMAGENET) == \
        (jfetch.KAGGLE_IMAGENET_VAL, jfetch.KAGGLEHUB_TINY_IMAGENET)
    done = tmp_path / "cached"
    done.mkdir()
    (done / ".fetch_complete").touch()
    assert fetch.fetch_imagenet_val(str(done)) == str(done)
    tiny = tmp_path / "tiny_done"
    tiny.mkdir()
    (tiny / ".fetch_complete").write_text("/somewhere/else")
    assert fetch.fetch_tiny_imagenet(str(tiny)) == "/somewhere/else"


def test_fetch_online_paths_with_fake_backends(tmp_path, monkeypatch):
    import sys
    import types

    from vit_pruning_tpu_torch.data import fetch

    calls = []

    class FakeKaggleApi:
        def authenticate(self):
            calls.append(("auth",))

        def dataset_download_files(self, dataset, path, unzip):
            calls.append(("download", dataset, path, unzip))

    ext = types.ModuleType("kaggle.api.kaggle_api_extended")
    ext.KaggleApi = FakeKaggleApi
    api_pkg = types.ModuleType("kaggle.api")
    api_pkg.kaggle_api_extended = ext
    kaggle_pkg = types.ModuleType("kaggle")
    kaggle_pkg.api = api_pkg
    monkeypatch.setitem(sys.modules, "kaggle", kaggle_pkg)
    monkeypatch.setitem(sys.modules, "kaggle.api", api_pkg)
    monkeypatch.setitem(sys.modules, "kaggle.api.kaggle_api_extended", ext)
    dest = tmp_path / "inval"
    assert fetch.fetch_imagenet_val(str(dest)) == str(dest)
    assert calls == [("auth",), ("download", fetch.KAGGLE_IMAGENET_VAL, str(dest), True)]
    assert fetch.fetch_imagenet_val(str(dest)) == str(dest) and len(calls) == 2

    cache = tmp_path / "hub_cache"
    cache.mkdir()
    hub = types.ModuleType("kagglehub")
    hub.dataset_download = lambda dataset: calls.append(dataset) or str(cache)
    monkeypatch.setitem(sys.modules, "kagglehub", hub)
    assert fetch.fetch_tiny_imagenet(str(tmp_path / "tiny")) == str(cache)
    assert fetch.fetch_tiny_imagenet(str(tmp_path / "tiny")) == str(cache)
    assert calls[2:] == [fetch.KAGGLEHUB_TINY_IMAGENET]


def test_cifar100_labels_equal():
    from vit_pruning_tpu.data.cifar100_labels import CIFAR100_FINE_LABELS as j_labels
    from vit_pruning_tpu_torch.data.cifar100_labels import CIFAR100_FINE_LABELS

    assert CIFAR100_FINE_LABELS == j_labels and len(CIFAR100_FINE_LABELS) == 100
