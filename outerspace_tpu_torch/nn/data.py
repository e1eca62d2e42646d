"""Synthetic MNIST-shaped inputs (numpy; bit-identical to the JAX
package's ``nn/data.py:synthetic_mnist`` for the same seed). No MNIST
files are in the tree, so tests and chip runs make their inputs here."""

from __future__ import annotations

import numpy as np


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
