"""The port's sparse-NN path on the CPU against the JAX package's: im2col,
the weight carry-over, the dense torch models against flax, and the
sparse forwards (``SparseMLP``, ``SparseLeNet``, ``mlp_forward_spmm``,
``mlp_forward_spgemm``, ``lenet_forward_spgemm``) with the committed
trained weights.

The bar is 1e-5 relative to the output's largest magnitude: sums are
taken in other orders than numpy's, flax's and the Pallas kernel's.
Inputs come from ``synthetic_mnist`` (bit-equal in both packages).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outerspace_tpu.nn import data as jdata
from outerspace_tpu.nn import export as jexport
from outerspace_tpu.nn import sparse_infer as jsi
from outerspace_tpu.nn.models import make_model as j_make_model
from outerspace_tpu.nn.train import load_params as j_load_params
from outerspace_tpu_torch.convert import load_params, state_dict_from_params
from outerspace_tpu_torch.nn import export, sparse_infer
from outerspace_tpu_torch.nn.data import synthetic_mnist
from outerspace_tpu_torch.nn.models import make_model
from outerspace_tpu_torch.ops.kernels import spmm as k5

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "data", "saved_weights")
ART = {
    "MLP1": os.path.join(WEIGHTS, "MLP1", "pruned10_finetuned.pkl"),
    "MLP1w": os.path.join(WEIGHTS, "MLP1w", "prune0p01_finetuned.pkl"),
    "LeNet": os.path.join(WEIGHTS, "LeNet", "pruned_finetuned"),
}
REL = 1e-5


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-9))


@pytest.fixture(scope="module")
def images():
    return synthetic_mnist(160, seed=0)["test"][0]  # 16 images, 28×28


def params(name):
    return load_params(ART[name])


def flax_forward(model_type, p, x):
    with jax.default_matmul_precision("float32"):
        logits, acts = j_make_model(model_type).apply({"params": p}, jnp.asarray(x))
    return np.asarray(logits), [np.asarray(a) for a in acts]


def torch_model(model_type, p):
    model = make_model(model_type)
    model.load_state_dict(state_dict_from_params(p))
    return model


def test_synthetic_mnist_bit_equal():
    got, want = synthetic_mnist(300, seed=4), jdata.synthetic_mnist(300, seed=4)
    for split in ("train", "val", "test"):
        for g, w in zip(got[split], want[split]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_load_params_equal():
    for path in ART.values():
        got, want = load_params(path), j_load_params(path)
        assert sorted(got) == sorted(want)
        for layer in got:
            for k in ("kernel", "bias"):
                np.testing.assert_array_equal(got[layer][k], want[layer][k])


@pytest.mark.parametrize("shape,kernel,pad", [((3, 14, 14, 6), 5, 0), ((2, 28, 28, 1), 5, 2),
                                              ((1, 8, 8, 2), 3, 1)])
def test_im2col_bit_equal(shape, kernel, pad):
    x = np.random.default_rng(sum(shape)).random(shape).astype(np.float32)
    got = export.im2col(torch.from_numpy(x), kernel, pad).numpy()
    np.testing.assert_array_equal(got, np.asarray(jexport.im2col(jnp.asarray(x), kernel, pad)))
    np.testing.assert_array_equal(got, jexport.im2col_np(x, kernel, pad))
    np.testing.assert_array_equal(export.im2col_np(x, kernel, pad), got)


def test_kernel_to_2d_equal():
    rng = np.random.default_rng(0)
    conv = rng.standard_normal((5, 5, 6, 16)).astype(np.float32)
    dense = rng.standard_normal((400, 120)).astype(np.float32)
    np.testing.assert_array_equal(export.conv_kernel_to_2d(conv), jexport.conv_kernel_to_2d(conv))
    np.testing.assert_array_equal(export.dense_kernel_to_2d(dense), jexport.dense_kernel_to_2d(dense))


@pytest.mark.parametrize("model_type", ["MLP1", "MLP1w", "LeNet"])
def test_dense_torch_models_match_flax(model_type, images):
    p = params(model_type)
    x = images[:8].reshape(8, 28, 28, 1) if model_type == "LeNet" else images[:8].reshape(8, -1)
    want_logits, want_acts = flax_forward(model_type, p, x)
    with torch.no_grad():
        logits, acts = torch_model(model_type, p)(torch.from_numpy(x))
    assert rel_err(logits.numpy(), want_logits) < REL
    assert len(acts) == len(want_acts)
    for a, w in zip(acts, want_acts):
        assert rel_err(a.numpy(), w) < REL


def test_state_dict_layouts_and_unknown_model():
    sd = state_dict_from_params(params("LeNet"))
    assert tuple(sd["conv.0.weight"].shape) == (6, 1, 5, 5)
    assert tuple(sd["conv.1.weight"].shape) == (16, 6, 5, 5)
    assert tuple(sd["dense.0.weight"].shape) == (120, 400)
    with pytest.raises(RuntimeError):  # MLP1 weights do not fit MLP1w
        torch_model("MLP1w", params("MLP1"))
    with pytest.raises(ValueError):
        make_model("ResNet")


def test_sparse_mlp_matches_jax(images):
    p = params("MLP1")
    x = images[:8].reshape(8, -1)
    before = k5.KERNEL.launches
    got = sparse_infer.SparseMLP(p, device="cpu")(x)
    assert k5.KERNEL.launches == before  # plain version on the CPU
    assert got.shape == (8, 10) and got.dtype == torch.float32
    want_jax = np.asarray(jsi.SparseMLP(p, interpret=True)(x))
    assert rel_err(got.numpy(), want_jax) < REL
    assert rel_err(got.numpy(), jsi.mlp_forward_dense(p, x)) < REL
    np.testing.assert_array_equal(sparse_infer.mlp_forward_dense(p, x), jsi.mlp_forward_dense(p, x))


def test_sparse_mlp_wide_matches_dense(images):
    """MLP1w, the 784-1000-1000-10 model the card serves at batch 1024."""
    p = params("MLP1w")
    x = images.reshape(16, -1)
    model = sparse_infer.SparseMLP(p, device="cpu")
    assert [layer.blocks.shape[:2] for layer in model.layers] == [(125, 7), (125, 8), (2, 8)]
    assert rel_err(model(x).numpy(), sparse_infer.mlp_forward_dense(p, x)) < REL


def test_mlp_forward_spmm_matches_jax(images):
    p = params("MLP1")
    x = images[:8]
    got = sparse_infer.mlp_forward_spmm(p, x, device="cpu")
    assert rel_err(got, jsi.mlp_forward_spmm(p, x, interpret=True)) < REL
    assert rel_err(got, jsi.mlp_forward_dense(p, x)) < REL


def test_mlp_forward_spgemm_matches_jax(images):
    p = params("MLP1")
    x = images[:8]
    want = jsi.mlp_forward_spgemm(p, x, backend="scipy")
    assert rel_err(sparse_infer.mlp_forward_spgemm(p, x, backend="torch", device="cpu"), want) < REL
    assert rel_err(sparse_infer.mlp_forward_spgemm(p, x, backend="scipy"), want) < REL
    with pytest.raises(ValueError, match="unknown backend"):
        sparse_infer.mlp_forward_spgemm(p, x, backend="tpu")


def test_sparse_lenet_matches_jax(images):
    p = params("LeNet")
    x = images[:2].reshape(2, 28, 28, 1)
    before = k5.KERNEL.launches
    got = sparse_infer.SparseLeNet(p, device="cpu")(x)
    assert k5.KERNEL.launches == before
    assert got.shape == (2, 10)
    assert rel_err(got.numpy(), np.asarray(jsi.SparseLeNet(p, interpret=True)(x))) < REL
    assert rel_err(got.numpy(), flax_forward("LeNet", p, x)[0]) < REL
    flat = sparse_infer.SparseLeNet(p, device="cpu")(images[:2].reshape(2, -1))
    assert torch.equal(flat, got)


def test_lenet_forward_spgemm_matches_jax(images):
    """Against the JAX package's scipy backend: its Pallas SpGEMM in
    interpret mode takes ~30 s for this forward on the CPU, and the
    port's SpGEMM is checked against that pipeline stream for stream in
    tests/test_torch_spgemm.py and tests/test_torch_tiled.py."""
    p = params("LeNet")
    x = images[:4]
    want = jsi.lenet_forward_spgemm(p, x, backend="scipy")
    got = sparse_infer.lenet_forward_spgemm(p, x, backend="torch", device="cpu")
    assert rel_err(got, want) < REL
    assert rel_err(sparse_infer.lenet_forward_spgemm(p, x, backend="scipy"), want) < REL
    assert rel_err(got, flax_forward("LeNet", p, x.reshape(4, 28, 28, 1))[0]) < REL


def test_sparse_models_need_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse_infer.SparseMLP(params("MLP1"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sparse_infer.SparseLeNet(params("LeNet"), device="cuda")
