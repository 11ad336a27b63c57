"""Dataset fetch (H6): the reference's first-run downloads, made explicit.

A copy of vit_pruning_tpu/data/fetch.py (plain Python, no jax), kept in
the port so that it imports nothing of the JAX package.

Reference behavior: `himanshu/hi_main.py:48-53` downloads imagenet1k-val via
the Kaggle API and `:84-86` pulls tiny-imagenet via kagglehub, implicitly on
first run, credentials assumed. Here fetching is an explicit, idempotent
call with clear failure modes, because training environments are often
egress-free: every loader in `datasets.py` takes a local
directory, and `fetch_*` is the optional step that populates it.

No kaggle package is a dependency — the functions import lazily
and raise a RuntimeError explaining what to install / where to put data
manually, instead of crashing mid-training like the reference.
"""

from __future__ import annotations

import os

KAGGLE_IMAGENET_VAL = "titericz/imagenet1k-val"  # hi_main.py:50
KAGGLEHUB_TINY_IMAGENET = "akash2sharma/tiny-imagenet"  # hi_main.py:85


def _done_marker(dest: str) -> str:
    return os.path.join(dest, ".fetch_complete")


def fetch_imagenet_val(dest: str) -> str:
    """Download+unzip imagenet1k-val into dest (hi_main.py:48-53).

    Idempotent: returns immediately if a previous fetch completed. Raises
    RuntimeError with remediation if the kaggle package/credentials/network
    are unavailable.
    """
    if os.path.exists(_done_marker(dest)):
        return dest
    try:
        from kaggle.api.kaggle_api_extended import KaggleApi
    except ImportError as e:
        raise RuntimeError(
            "the 'kaggle' package is not installed in this environment; "
            "install it (pip install kaggle) with ~/.kaggle/kaggle.json "
            f"credentials, or place the extracted dataset at {dest!r} "
            "yourself and pass that path to ImageFolderDataset"
        ) from e
    api = KaggleApi()
    api.authenticate()
    os.makedirs(dest, exist_ok=True)
    api.dataset_download_files(KAGGLE_IMAGENET_VAL, path=dest, unzip=True)
    open(_done_marker(dest), "w").close()
    return dest


def fetch_tiny_imagenet(dest: str) -> str:
    """kagglehub tiny-imagenet pull (hi_main.py:84-86). kagglehub manages its
    own cache dir, so the marker under dest records the RESOLVED path and the
    function always returns the directory that actually holds the data."""
    marker = _done_marker(dest)
    if os.path.exists(marker):
        with open(marker) as f:
            recorded = f.read().strip()
        return recorded or dest
    try:
        import kagglehub
    except ImportError as e:
        raise RuntimeError(
            "the 'kagglehub' package is not installed; install it or place "
            f"the tiny-imagenet ImageFolder tree at {dest!r} manually"
        ) from e
    path = kagglehub.dataset_download(KAGGLEHUB_TINY_IMAGENET)
    os.makedirs(dest, exist_ok=True)
    with open(marker, "w") as f:
        f.write(path)
    return path
