"""Compaction of a merged stream on its device: the port's
``compact_to_csr_device``, and ``front_compact`` with the INT32_MAX row
that the JAX package's ``_compact_device`` leaves, equal the JAX
package's element for element, and ``MergedCOO.to_csr`` (which
now compacts before the copy) equals the host route it replaced."""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import outerspace_tpu.ops.chain as jchain
import outerspace_tpu_torch.ops.gather_pipeline as tgp
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays
from outerspace_tpu_torch.formats import CSR
from outerspace_tpu_torch.ops.chain import compact_to_csr_device, front_compact

# the modules (each package's ``ops`` also exports the function ``spgemm``)
jsp = importlib.import_module("outerspace_tpu.ops.spgemm")
tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")


def merged_stream(seed, n, m, p_valid):
    """A row-major sorted merged stream of length ``n``: valid slots at
    random with sorted rows < m, the others holding the sentinel row m."""
    rng = np.random.default_rng(seed)
    valid = rng.random(n) < p_valid
    rows = np.sort(rng.integers(0, m, size=n)).astype(np.int32)
    rows[~valid] = m
    cols = rng.integers(0, 97, size=n).astype(np.int32)
    vals = rng.standard_normal(n).astype(np.float32)
    return rows, cols, vals, valid


CASES = {
    # (seed, stream length, m, share of valid slots, nnz_pad as a function of nnz)
    "exact": (0, 500, 40, 0.6, lambda nnz: nnz),
    "padded": (1, 777, 300, 0.3, lambda nnz: nnz + 123),
    "dropped": (2, 640, 25, 0.8, lambda nnz: nnz - 50),
    "all_invalid": (3, 256, 10, 0.0, lambda nnz: 64),
    "all_valid": (4, 300, 7, 1.0, lambda nnz: nnz),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_compact_to_csr_device_equals_jax(name):
    seed, n, m, p_valid, pad = CASES[name]
    rows, cols, vals, valid = merged_stream(seed, n, m, p_valid)
    nnz_pad = pad(int(valid.sum()))
    want = jchain.compact_to_csr_device(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(valid),
        nnz_pad=nnz_pad, m=m,
    )
    got = compact_to_csr_device(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals),
        torch.from_numpy(valid), nnz_pad=nnz_pad, m=m,
    )
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == getattr(torch, str(w.dtype)) and g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("name", ["exact", "padded", "all_invalid", "all_valid"])
def test_compact_device_equals_jax(name):
    seed, n, m, p_valid, _ = CASES[name]
    rows, cols, vals, valid = merged_stream(seed, n, m, p_valid)
    want = jsp._compact_device(
        jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), jnp.asarray(valid), p_pad=n
    )
    got = front_compact(
        torch.from_numpy(rows), torch.from_numpy(cols), torch.from_numpy(vals),
        torch.from_numpy(valid), n, tsp.I32_MAX,
    )
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def host_route_to_csr(merged):
    """``MergedCOO.to_csr`` before compaction on the device: every padded
    slot fetched, masked and counted on the host."""
    valid = merged.valid.cpu().numpy()
    rows = merged.rows.cpu().numpy()[valid]
    cols = merged.cols.cpu().numpy()[valid]
    vals = merged.vals.cpu().numpy()[valid]
    indptr = np.zeros(merged.shape[0] + 1, dtype=np.int64)
    np.cumsum(np.bincount(rows, minlength=merged.shape[0]), out=indptr[1:])
    return CSR(merged.shape, indptr, cols, vals)


def port(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
    )


@pytest.mark.parametrize("path", ["gather", "tiles", "flat"])
def test_to_csr_equals_the_host_route(operand_pair, path):
    ta, tb = port(*operand_pair)
    if path == "gather":
        merged = tgp.spgemm_gather_padded(tgp.plan_spgemm_gather(ta, tb, device="cpu"))
    elif path == "tiles":
        merged = tsp.spgemm_padded_tiled_parts(tsp.plan_tiled_parts(ta, tb, device="cpu"))
    else:
        merged = tsp.spgemm_padded(tsp.expansion_plan(ta, tb), device="cpu")
    got, want = merged.to_csr(), host_route_to_csr(merged)
    assert got.shape == want.shape and got.indptr.dtype == np.int64
    np.testing.assert_array_equal(got.indptr, want.indptr)
    np.testing.assert_array_equal(got.indices, want.indices)
    np.testing.assert_array_equal(got.data.view(np.int32), want.data.view(np.int32))
