"""The port's native (C++) preprocessing, built from its own copy of the
source, against the JAX package's build: bit-equal, and byte-equal to PIL.
Also the build itself (its directory and the rebuild on a changed source)
and the PIL fallback."""

import numpy as np
import pytest

from vit_pruning_tpu import native as jnative
from vit_pruning_tpu.data.preprocess import pil_preprocess as j_pil
from vit_pruning_tpu_torch import native
from vit_pruning_tpu_torch.data.preprocess import pil_preprocess

pytestmark = pytest.mark.skipif(
    not (native.available() and jnative.available()), reason="native build unavailable (no g++?)"
)

RNG = np.random.RandomState(0)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((32, 32), (224, 224)),   # CIFAR upscale
    ((64, 64), (224, 224)),   # TinyImageNet upscale
    ((224, 224), (96, 128)),  # downscale, non-square
    ((100, 67), (31, 45)),    # odd sizes both ways
    ((224, 224), (224, 224)), # identity
    ((50, 224), (224, 50)),   # one axis up, one down
])
def test_resize_bit_equal_to_the_reference_build_and_pil(in_hw, out_hw):
    from PIL import Image

    (h, w), (oh, ow) = in_hw, out_hw
    ims = RNG.randint(0, 256, (3, h, w, 3), np.uint8)
    ours = native.resize_bilinear(ims, oh, ow)
    np.testing.assert_array_equal(ours, jnative.resize_bilinear(ims, oh, ow))
    ref = np.stack([np.asarray(Image.fromarray(im).resize((ow, oh), Image.BILINEAR)) for im in ims])
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("in_hw,size,mean,std", [
    ((32, 32), 224, 0.5, 0.5),
    ((64, 48), 96, 0.5, 0.5),
    ((300, 300), 224, 0.45, 0.22),
])
def test_fused_preprocess_bit_equal_to_the_reference_build(in_hw, size, mean, std):
    ims = RNG.randint(0, 256, (4, *in_hw, 3), np.uint8)
    ours = native.preprocess(ims, size=size, mean=mean, std=std)
    assert ours.dtype == np.float32 and ours.shape == (4, 3, size, size)
    np.testing.assert_array_equal(ours, jnative.preprocess(ims, size=size, mean=mean, std=std))
    np.testing.assert_array_equal(ours, j_pil(list(ims), size=size, mean=mean, std=std,
                                              _force_pil=True))


def test_threaded_equals_single_thread():
    ims = RNG.randint(0, 256, (8, 48, 40, 3), np.uint8)
    np.testing.assert_array_equal(native.preprocess(ims, size=64, nthreads=1),
                                  native.preprocess(ims, size=64, nthreads=4))
    np.testing.assert_array_equal(native.resize_bilinear(ims, 224, 224, nthreads=1),
                                  native.resize_bilinear(ims, 224, 224, nthreads=4))


def test_pil_preprocess_native_path_equals_pil_loop_and_reference():
    ims = RNG.randint(0, 256, (5, 32, 32, 3), np.uint8)
    fast = pil_preprocess(list(ims), size=96)
    np.testing.assert_array_equal(fast, pil_preprocess(list(ims), size=96, _force_pil=True))
    np.testing.assert_array_equal(fast, j_pil(list(ims), size=96))
    # generators (single pass) and per-channel stats (the PIL loop)
    np.testing.assert_array_equal(pil_preprocess((im for im in ims), size=64),
                                  pil_preprocess(ims, size=64))
    mean, std = np.float32([0.485, 0.456, 0.406]), np.float32([0.229, 0.224, 0.225])
    np.testing.assert_array_equal(pil_preprocess(ims, size=64, mean=mean, std=std),
                                  j_pil(ims, size=64, mean=mean, std=std))


def test_rejects_bad_input():
    with pytest.raises(ValueError):
        native.preprocess(RNG.rand(2, 32, 32, 3).astype(np.float32))
    with pytest.raises(ValueError):
        native.preprocess(RNG.randint(0, 256, (2, 32, 32, 4), np.uint8))
    with pytest.raises(ValueError, match="scalar"):
        native.preprocess(RNG.randint(0, 256, (2, 32, 32, 3), np.uint8), mean=[0.5] * 3)


def test_build_lands_in_its_directory_and_rebuilds_on_a_changed_source(tmp_path, monkeypatch):
    """The library is keyed by the source's hash, in the port's own build
    directory (never the JAX package's); an edited source builds anew and
    the stale library is removed. VIT_PRUNING_NO_NATIVE forces the PIL
    fallback."""
    import os

    src = tmp_path / "preprocess.cpp"
    src.write_text(open(native._SRC).read())
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setenv("VIT_PRUNING_TORCH_NATIVE_CACHE", str(tmp_path / "build"))
    assert native.build_dir() == str(tmp_path / "build")
    native._build_and_load()
    first = os.listdir(tmp_path / "build")
    src.write_text(src.read_text() + "\n// edited\n")
    native._build_and_load()
    second = os.listdir(tmp_path / "build")
    assert len(first) == len(second) == 1 and first != second
    monkeypatch.delenv("VIT_PRUNING_TORCH_NATIVE_CACHE")
    assert native.build_dir().endswith(os.path.join("vit_pruning_tpu_torch", "native", "_build"))

    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("VIT_PRUNING_NO_NATIVE", "1")
    assert not native.available()
    ims = RNG.randint(0, 256, (2, 32, 32, 3), np.uint8)
    np.testing.assert_array_equal(pil_preprocess(ims, size=48), j_pil(ims, size=48))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.preprocess(ims)


def test_a_failed_build_warns_and_falls_back(tmp_path, monkeypatch):
    src = tmp_path / "preprocess.cpp"
    src.write_text("this is not C++")
    monkeypatch.setattr(native, "_SRC", str(src))
    monkeypatch.setenv("VIT_PRUNING_TORCH_NATIVE_CACHE", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.warns(RuntimeWarning, match="falling back to PIL"):
        assert not native.available()
    ims = RNG.randint(0, 256, (2, 32, 32, 3), np.uint8)
    np.testing.assert_array_equal(pil_preprocess(ims, size=48), j_pil(ims, size=48))
