"""MNIST data: idx files when there are any, and a deterministic
synthetic stand-in (numpy; the JAX package's ``nn/data.py``, bit-identical
for the same files and seeds).

- ``load_mnist`` reads the idx files it finds (plain or ``.gz``) in
  ``$OUTERSPACE_MNIST_DIR`` or the repository's ``data/MNIST/raw`` and
  splits all of them deterministically (80/10/10 at seed 42);
- ``synthetic_mnist`` renders digit-like images procedurally; no MNIST
  files are in the tree, so tests and runs on the card train on it;
- ``batch_index_sets`` / ``batches`` give one shuffled epoch's full
  batches. The training loop stages each split on the device once and
  gathers every batch there with these index sets.
"""

from __future__ import annotations

import gzip
import os
import struct

import numpy as np

_REPO_MNIST = os.path.join(os.path.dirname(__file__), "..", "..", "data", "MNIST", "raw")


def _open_maybe_gz(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    raise FileNotFoundError(path)


def _read_idx_images(path: str) -> np.ndarray:
    """(n, rows, cols) float32 in [0, 1] from an idx3 file."""
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        if magic != 2051:
            raise ValueError(f"bad magic {magic} in {path}")
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols).astype(np.float32) / 255.0


def _read_idx_labels(path: str) -> np.ndarray:
    """(n,) int32 labels from an idx1 file."""
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        if magic != 2049:
            raise ValueError(f"bad magic {magic} in {path}")
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int32)


def find_mnist_dir() -> str | None:
    """The first of ``$OUTERSPACE_MNIST_DIR`` and ``data/MNIST/raw`` that
    holds the test labels (plain or ``.gz``), or None."""
    for d in (os.environ.get("OUTERSPACE_MNIST_DIR", ""), _REPO_MNIST):
        if d and any(
            os.path.exists(os.path.join(d, "t10k-labels-idx1-ubyte" + ext))
            for ext in ("", ".gz")
        ):
            return d
    return None


def load_mnist(
    data_dir: str | None = None,
    splits: tuple[float, float, float] = (0.8, 0.1, 0.1),
    seed: int = 42,
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Load whatever MNIST idx pairs exist under ``data_dir`` (default
    :func:`find_mnist_dir`); returns {"train", "val", "test"}: all pairs
    pooled, shuffled at ``seed`` and split by ``splits``."""
    data_dir = data_dir or find_mnist_dir()
    if data_dir is None:
        raise FileNotFoundError("no MNIST idx files found; use synthetic_mnist() instead")
    images, labels = [], []
    for img, lab in [
        ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    ]:
        try:
            x = _read_idx_images(os.path.join(data_dir, img))
            y = _read_idx_labels(os.path.join(data_dir, lab))
        except FileNotFoundError:
            continue
        images.append(x)
        labels.append(y)
    if not images:
        raise FileNotFoundError(f"no readable MNIST pairs under {data_dir}")
    x = np.concatenate(images)
    y = np.concatenate(labels)
    perm = np.random.default_rng(seed).permutation(x.shape[0])
    x, y = x[perm], y[perm]
    n = x.shape[0]
    n_tr = int(splits[0] * n)
    n_va = int(splits[1] * n)
    return {
        "train": (x[:n_tr], y[:n_tr]),
        "val": (x[n_tr : n_tr + n_va], y[n_tr : n_tr + n_va]),
        "test": (x[n_tr + n_va :], y[n_tr + n_va :]),
    }


def synthetic_mnist(
    n: int = 4096, seed: int = 0
) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Procedural digit-like 28×28 images: each class is a fixed stroke
    pattern plus noise — learnable by a small net, fully deterministic.
    Split 80/10/10 into "train", "val" and "test" (images, labels)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    base = np.zeros((10, 28, 28), dtype=np.float32)
    proto_rng = np.random.default_rng(1234)
    for c in range(10):
        # Random strokes per class prototype.
        for _ in range(4 + c % 3):
            r0, c0 = proto_rng.integers(4, 24, 2)
            dr, dc = proto_rng.integers(-3, 4, 2)
            for t in range(8):
                rr = np.clip(r0 + t * dr // 2, 0, 27)
                cc = np.clip(c0 + t * dc // 2, 0, 27)
                base[c, rr, cc] = 1.0
    x = base[labels]
    x = x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
    x = np.clip(x, 0.0, 1.0)
    n_tr, n_va = int(0.8 * n), int(0.1 * n)
    return {
        "train": (x[:n_tr], labels[:n_tr]),
        "val": (x[n_tr : n_tr + n_va], labels[n_tr : n_tr + n_va]),
        "test": (x[n_tr + n_va :], labels[n_tr + n_va :]),
    }


def batch_index_sets(n: int, batch_size: int, seed: int = 0) -> np.ndarray:
    """(n // batch_size, batch_size) index sets of one shuffled epoch over
    ``n`` examples: full batches only, the ragged tail dropped."""
    perm = np.random.default_rng(seed).permutation(n)
    nb = n // batch_size
    return perm[: nb * batch_size].reshape(nb, batch_size)


def batches(x: np.ndarray, y: np.ndarray, batch_size: int, seed: int = 0):
    """Shuffled full batches ``(x[idx], y[idx])`` of one epoch."""
    for idx in batch_index_sets(x.shape[0], batch_size, seed):
        yield x[idx], y[idx]
