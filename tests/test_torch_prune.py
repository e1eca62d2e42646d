"""The port's pruning (``nn/prune.py``) against the JAX package's on the
committed trained weights: the masks of ``prune_params`` (fc 0.1, conv
0.25) and ``zero_small_weights`` are equal element for element, and the
sparsity counts and thresholds are equal. The port works on a torch
``state_dict``, the JAX package on the flax dict; ``convert`` carries
the weights across exactly, so the comparison is exact."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from outerspace_tpu.nn import prune as jprune
from outerspace_tpu_torch.convert import (
    load_params,
    params_from_state_dict,
    state_dict_from_params,
)
from outerspace_tpu_torch.nn import prune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(REPO, "data", "saved_weights")
ART = {
    "MLP1 dense_l2": os.path.join(WEIGHTS, "MLP1", "dense_l2.pkl"),
    "MLP1w prune0p01_finetuned": os.path.join(WEIGHTS, "MLP1w", "prune0p01_finetuned.pkl"),
    "LeNet dense_l2": os.path.join(WEIGHTS, "LeNet", "dense_l2"),
}


def jax_params(name):
    return {k: {n: jnp.asarray(a) for n, a in v.items()} for k, v in load_params(ART[name]).items()}


def assert_trees_equal(port_sd, jax_tree):
    got = params_from_state_dict(port_sd)
    assert sorted(got) == sorted(jax_tree)
    for layer in got:
        for leaf in ("kernel", "bias"):
            want = np.asarray(jax_tree[layer][leaf])
            np.testing.assert_array_equal(got[layer][leaf] != 0, want != 0, err_msg=f"{layer}/{leaf}")
            np.testing.assert_array_equal(got[layer][leaf], want, err_msg=f"{layer}/{leaf}")


@pytest.mark.parametrize("name", list(ART))
def test_prune_params_masks_equal_jax(name):
    p = jax_params(name)
    sd = state_dict_from_params(load_params(ART[name]))
    got = prune.prune_params(sd, sparsity_level=0.1, conv_sparsity_level=0.25)
    assert_trees_equal(got, jprune.prune_params(p, sparsity_level=0.1, conv_sparsity_level=0.25))
    # biases pass through untouched
    for k, v in sd.items():
        if k.endswith("bias"):
            assert torch.equal(got[k], v)


@pytest.mark.parametrize("name", list(ART))
def test_prune_params_one_level_for_all_equal_jax(name):
    # conv_sparsity_level=None: conv weights take the fc level too
    p = jax_params(name)
    sd = state_dict_from_params(load_params(ART[name]))
    got = prune.prune_params(sd, sparsity_level=0.05, conv_sparsity_level=None)
    assert_trees_equal(got, jprune.prune_params(p, sparsity_level=0.05, conv_sparsity_level=None))


@pytest.mark.parametrize("name", list(ART))
def test_zero_small_weights_equal_jax(name):
    p = jax_params(name)
    sd = state_dict_from_params(load_params(ART[name]))
    for thr in (1e-2, 3e-2):
        assert_trees_equal(prune.zero_small_weights(sd, thr), jprune.zero_small_weights(p, thr))


@pytest.mark.parametrize("name", list(ART))
def test_sparsity_report_and_thresholds_equal_jax(name):
    p = jax_params(name)
    sd = state_dict_from_params(load_params(ART[name]))
    pruned = prune.prune_params(sd)
    want = jprune.sparsity_report(jprune.prune_params(p))
    got = prune.sparsity_report(pruned)
    # the port names tensors by state_dict key: conv.i / dense.i ↔ Conv_i / Dense_i
    renamed = {}
    for key, counts in got.items():
        prefix, i, kind = key.split(".")
        renamed[f"{prefix.capitalize()}_{i}/{'kernel' if kind == 'weight' else 'bias'}"] = counts
    assert renamed == want
    for key, w in sd.items():
        layer = p[f"{key.split('.')[0].capitalize()}_{key.split('.')[1]}"]
        jw = layer["kernel" if key.endswith("weight") else "bias"]
        assert prune.get_sparsity(w) == jprune.get_sparsity(jw)
        for level in (0.1, 0.25):
            assert prune.prune_threshold(w, level) == jprune.prune_threshold(jw, level)


def test_small_weight_threshold_compared_in_float32():
    # float32(0.01) is below the float64 0.01: a weight equal to it is kept
    # by the float32 comparison of both packages (a float64 one drops it)
    t = np.float32(0.01)
    assert float(t) < 0.01
    w = np.array([[t, -t, np.nextafter(t, np.float32(0)), 0.5]], np.float32)
    sd = {"dense.0.weight": torch.from_numpy(w.copy()), "dense.0.bias": torch.zeros(1)}
    got = prune.zero_small_weights(sd, 1e-2)["dense.0.weight"].numpy()
    want = np.asarray(jprune.zero_small_weights(
        {"Dense_0": {"kernel": jnp.asarray(w.T), "bias": jnp.zeros(1)}}, 1e-2)["Dense_0"]["kernel"]).T
    np.testing.assert_array_equal(want, [[t, -t, 0.0, 0.5]])
    np.testing.assert_array_equal(got, want)


def test_nonzero_masks_and_grad_mask():
    sd = state_dict_from_params(load_params(ART["LeNet dense_l2"]))
    pruned = prune.prune_params(sd)
    masks = prune.nonzero_masks(pruned)
    assert sorted(masks) == sorted(k for k in sd if k.endswith("weight"))
    jm = jprune.nonzero_masks(jprune.prune_params(jax_params("LeNet dense_l2")))
    for k, m in params_from_state_dict({k: v.float() for k, v in masks.items()}).items():
        np.testing.assert_array_equal(m["kernel"] != 0, np.asarray(jm[k]["kernel"]))

    from outerspace_tpu_torch.nn.models import make_model

    model = make_model("LeNet")
    model.load_state_dict(pruned)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    prune.apply_grad_mask(model, masks)
    for name, p in model.named_parameters():
        want = masks[name].float() if name in masks else torch.ones_like(p)
        assert torch.equal(p.grad, want)
