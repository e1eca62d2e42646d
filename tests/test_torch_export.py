"""The port's exporters and format writers against the JAX package's:
``write_mtx`` writes the same bytes for the same matrix, ``COO``'s
sorted orders are equal, ``export_mlp1`` / ``export_lenet`` write the
same file set with weight files byte-equal (the activation and logits
files are computed by other float32 sums: read back with the same shape
and values within 1e-6 of each file's max |y|, the NN parity bar), and the MNIST idx readers and ``load_mnist`` read idx files
(plain and ``.gz``) that each test writes itself."""

import gzip
import os
import struct
from pathlib import Path

import jax
import numpy as np
import pytest

from outerspace_tpu.formats import COO as JCOO
from outerspace_tpu.formats import write_mtx as j_write_mtx
from outerspace_tpu.nn import data as jdata
from outerspace_tpu.nn import export as jexport
from outerspace_tpu_torch.convert import load_params, state_dict_from_params
from outerspace_tpu_torch.formats import COO, read_mtx, write_mtx
from outerspace_tpu_torch.nn import data, export
from outerspace_tpu_torch.nn.prune import prune_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "data", "saved_weights")


def random_coo(seed, shape=(37, 53), density=0.2):
    rng = np.random.default_rng(seed)
    d = np.where(rng.random(shape) < density, rng.standard_normal(shape), 0).astype(np.float32)
    d[0, 0] = 1e-30  # tiny and huge magnitudes through %.9g
    d[-1, -1] = -3.4e38
    r, c = np.nonzero(d)
    p = rng.permutation(r.size)  # unsorted input
    return d.shape, r[p], c[p], d[r[p], c[p]]


@pytest.mark.parametrize("seed", [0, 1])
def test_write_mtx_byte_equal_jax(tmp_path, seed):
    shape, r, c, v = random_coo(seed)
    write_mtx(str(tmp_path / "port" / "a.mtx"), COO(shape, r, c, v), comment="two\nlines")
    j_write_mtx(str(tmp_path / "jax" / "a.mtx"), JCOO(shape, r, c, v), comment="two\nlines")
    got = (tmp_path / "port" / "a.mtx").read_bytes()
    assert got == (tmp_path / "jax" / "a.mtx").read_bytes()
    # a CSR writes the same file; the reader reads it back exactly
    write_mtx(str(tmp_path / "csr.mtx"), COO(shape, r, c, v).to_csr(), comment="two\nlines")
    assert (tmp_path / "csr.mtx").read_bytes() == got
    back = read_mtx(str(tmp_path / "csr.mtx"))
    np.testing.assert_array_equal(back.to_dense(), COO(shape, r, c, v).to_dense())


def test_sorted_orders_equal_jax():
    shape, r, c, v = random_coo(2)
    port, ref = COO(shape, r, c, v), JCOO(shape, r, c, v)
    for name in ("sorted_rowmajor", "sorted_colmajor"):
        got, want = getattr(port, name)(), getattr(ref, name)()
        for f in ("row", "col", "val"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    np.testing.assert_array_equal(port.argsort_colmajor(), ref.argsort_colmajor())


def images(n):
    return data.synthetic_mnist(10 * n, seed=1)["test"][0][:n]


def compare_exports(files, jfiles):
    assert sorted(files) == sorted(jfiles)
    for k in files:
        assert os.path.basename(files[k]) == os.path.basename(jfiles[k])
        if "weight" in k:
            assert Path(files[k]).read_bytes() == Path(jfiles[k]).read_bytes(), k
        else:
            # the NN parity bar: 1e-6 of the file's max |y| (the two
            # packages sum the same terms in other orders)
            g, w = read_mtx(files[k]).to_dense(), read_mtx(jfiles[k]).to_dense()
            assert g.shape == w.shape, k
            atol = 1e-6 * float(np.abs(w).max(initial=0.0))
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("artifact", ["MLP1/pruned10_finetuned.pkl", "MLP1/dense_l2.pkl"])
def test_export_mlp1_equal_jax(tmp_path, artifact):
    flax = load_params(os.path.join(WEIGHTS, artifact))
    x = images(12)
    files = export.export_mlp1(state_dict_from_params(flax), x, str(tmp_path / "port"), device="cpu")
    with jax.default_matmul_precision("float32"):
        jfiles = jexport.export_mlp1(flax, x, str(tmp_path / "jax"))
    compare_exports(files, jfiles)
    assert sorted(files) == ["act_0", "act_1", "act_2", "fc1_weight", "fc2_weight",
                             "fc3_weight", "logits"]


def test_export_mlp1w_equal_jax(tmp_path):
    # the wide variant's hidden widths come from the weights
    flax = load_params(os.path.join(WEIGHTS, "MLP1w", "prune0p01_finetuned.pkl"))
    x = images(4)
    files = export.export_mlp1(state_dict_from_params(flax), x, str(tmp_path / "port"), device="cpu")
    with jax.default_matmul_precision("float32"):
        jfiles = jexport.export_mlp1(flax, x, str(tmp_path / "jax"))
    compare_exports(files, jfiles)
    assert read_mtx(files["act_1"]).shape == (4, 1000)


@pytest.mark.parametrize("artifact", ["pruned_finetuned", "dense_l2"])
def test_export_lenet_equal_jax(tmp_path, artifact):
    flax = load_params(os.path.join(WEIGHTS, "LeNet", artifact))
    x = images(6)
    files = export.export_lenet(state_dict_from_params(flax), x, str(tmp_path / "port"), device="cpu")
    with jax.default_matmul_precision("float32"):
        jfiles = jexport.export_lenet(flax, x, str(tmp_path / "jax"))
    compare_exports(files, jfiles)
    assert read_mtx(files["conv1_input"]).shape == (6 * 28 * 28, 25)
    assert read_mtx(files["conv2_weight"]).shape == (16, 150)


def test_export_layer_contract(tmp_path):
    # act_i × fc(i+1)_weightᵀ (+ bias, ReLU) gives act_(i+1): the files
    # are the layers' GEMM operands
    sd = prune_params(state_dict_from_params(load_params(os.path.join(WEIGHTS, "MLP1", "dense_l2.pkl"))))
    files = export.export_mlp1(sd, images(5), str(tmp_path), weight_zero_tol=0.0, device="cpu")
    act = read_mtx(files["act_0"]).to_dense()
    for i, nxt in enumerate(["act_1", "act_2", "logits"]):
        w = read_mtx(files[f"fc{i + 1}_weight"]).to_dense()
        y = act @ w.T + sd[f"dense.{i}.bias"].numpy()
        if nxt != "logits":
            y = np.maximum(y, 0)
        np.testing.assert_allclose(read_mtx(files[nxt]).to_dense(), y, rtol=1e-5, atol=1e-5)
        act = read_mtx(files[nxt]).to_dense()


def write_idx(d, n=5, rows=28, cols=28, gz=(), seed=0, split="t10k"):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (n, rows, cols), dtype=np.uint8)
    labels = rng.integers(0, 10, n, dtype=np.uint8)
    for name, head, body in (
        (f"{split}-images-idx3-ubyte", struct.pack(">IIII", 2051, n, rows, cols), imgs.tobytes()),
        (f"{split}-labels-idx1-ubyte", struct.pack(">II", 2049, n), labels.tobytes()),
    ):
        path = os.path.join(d, name)
        if name.split("-")[1] in gz:
            with gzip.open(path + ".gz", "wb") as f:
                f.write(head + body)
        else:
            with open(path, "wb") as f:
                f.write(head + body)
    return imgs, labels


@pytest.mark.parametrize("gz", [(), ("images",), ("images", "labels")])
def test_idx_readers(tmp_path, gz):
    imgs, labels = write_idx(str(tmp_path), gz=gz)
    x = data._read_idx_images(str(tmp_path / "t10k-images-idx3-ubyte"))
    y = data._read_idx_labels(str(tmp_path / "t10k-labels-idx1-ubyte"))
    assert x.dtype == np.float32 and y.dtype == np.int32
    np.testing.assert_array_equal(x, imgs.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(y, labels)
    np.testing.assert_array_equal(x, jdata._read_idx_images(str(tmp_path / "t10k-images-idx3-ubyte")))
    np.testing.assert_array_equal(y, jdata._read_idx_labels(str(tmp_path / "t10k-labels-idx1-ubyte")))


def test_idx_reader_refuses_bad_magic(tmp_path):
    with open(tmp_path / "bad-images", "wb") as f:
        f.write(struct.pack(">IIII", 2049, 1, 1, 1) + b"\0")
    with pytest.raises(ValueError, match="bad magic"):
        data._read_idx_images(str(tmp_path / "bad-images"))
    with pytest.raises(FileNotFoundError):
        data._read_idx_labels(str(tmp_path / "missing"))


def test_load_mnist_equal_jax(tmp_path, monkeypatch):
    write_idx(str(tmp_path), n=30, gz=("images",), seed=1, split="t10k")
    write_idx(str(tmp_path), n=50, seed=2, split="train")
    got = data.load_mnist(str(tmp_path))
    want = jdata.load_mnist(str(tmp_path))
    for split in ("train", "val", "test"):
        for a, b in zip(got[split], want[split]):
            np.testing.assert_array_equal(a, b)
    assert got["train"][0].shape == (64, 28, 28)
    # the directory is found through $OUTERSPACE_MNIST_DIR
    monkeypatch.setenv("OUTERSPACE_MNIST_DIR", str(tmp_path))
    assert data.find_mnist_dir() == str(tmp_path)
    monkeypatch.setenv("OUTERSPACE_MNIST_DIR", str(tmp_path / "none"))
    assert data.find_mnist_dir() in (None, data._REPO_MNIST)
    with pytest.raises(FileNotFoundError):
        data.load_mnist(str(tmp_path / "none"))
