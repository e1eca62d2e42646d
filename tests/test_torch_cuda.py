"""The port's CUDA kernels on the card, against their plain versions and
scipy. Marked ``cuda``: each test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import functools
import os

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.convert import load_params, state_dict_from_params
from outerspace_tpu_torch.formats import COO, BlockELL, erdos_renyi, rmat
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy
from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather
from outerspace_tpu_torch.nn.data import synthetic_mnist
from outerspace_tpu_torch.nn.models import make_model
from outerspace_tpu_torch.nn.sparse_infer import SparseLeNet, SparseMLP
from outerspace_tpu_torch.ops.kernels import expand, gexpand, scan, spmm
from outerspace_tpu_torch.ops.spgemm import plan_tiled, spgemm_padded_tiled

import torch_cases  # tests/ is on sys.path under pytest

big_shape_pair = functools.partial(torch_cases.big_shape_pair, COO)

pytestmark = pytest.mark.cuda
RTOL, ATOL = 1e-5, 1e-6
I32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def test_k1_kernel_bit_equal_to_plain(cuda):
    g = rmat(10, edge_factor=8, seed=1)
    plan = plan_spgemm_gather(g.to_csc(), g.to_csr(), device=cuda)
    for p in plan.parts:
        d = p.dev
        args = (d["bases"], d["table"], d["a_pack"], d["b_pack"], d["group_bits"])
        before = gexpand.KERNEL.launches
        k, v = gexpand.expand_gather(*args, b_win=p.b_win)
        kp, vp = gexpand.expand_gather_plain(*args, b_win=p.b_win)
        torch.cuda.synchronize()
        assert gexpand.KERNEL.launches == before + 1
        assert torch.equal(k, kp)
        assert torch.equal(v.view(torch.int32), vp.view(torch.int32))
        assert int((k != I32_MAX).sum()) == p.p_real


@pytest.mark.parametrize("n,pad_count,corner", [(5000, 100, 0), (8192, 96, 3), (8192, 100, 3), (1, 0, 0)])
def test_k2_kernel_matches_plain(cuda, n, pad_count, corner):
    rng = np.random.default_rng(n + pad_count)
    m = n_cols = 65536
    pad = min(97 if corner else pad_count, n)
    real = n - pad
    flat = np.repeat(rng.choice(m * n_cols, size=real, replace=False), rng.integers(1, 7, size=real))[:real]
    if corner:
        flat[-corner:] = m * n_cols - 1
    key = np.sort(np.concatenate([(np.sort(flat) - 2**31).astype(np.int32), np.full(pad, I32_MAX, np.int32)]))
    vals = rng.normal(size=n).astype(np.float32)
    kt, vt = torch.from_numpy(key).to(cuda), torch.from_numpy(vals).to(cuda)
    before = scan.KERNEL.launches
    got = scan.merge_epilogue_scan(kt, vt, pad_count, n_cols=n_cols, sentinel_row=m)
    want = scan.merge_epilogue_plain(kt, vt, pad_count, n_cols=n_cols, sentinel_row=m)
    torch.cuda.synchronize()
    assert scan.KERNEL.launches == before + 1
    for i in (0, 1, 3, 4):
        assert torch.equal(got[i], want[i]), i
    torch.testing.assert_close(got[2], want[2], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize(
    "make",
    [
        lambda: (erdos_renyi(64, 64, 0.08, seed=1), erdos_renyi(64, 64, 0.08, seed=2)),
        lambda: (erdos_renyi(48, 96, 0.1, seed=3), erdos_renyi(96, 32, 0.07, seed=4)),
        lambda: (rmat(12, edge_factor=8, seed=5),) * 2,
        lambda: (erdos_renyi(70_000, 70_000, 2e-5, seed=6),) * 2,
        lambda: (COO((65536, 2), [65535, 3], [0, 1], [1.5, 2.0]), COO((2, 65536), [0, 1], [65535, 7], [2.0, 1.0])),
    ],
    ids=["er64", "rect", "rmat12", "er70k", "corner_2e32"],
)
def test_spgemm_on_card_matches_scipy(cuda, make):
    a, b = make()
    assert_csr_allclose(spgemm(a, b, device=cuda), spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def test_wrappers_reject_mixed_devices(cuda):
    key = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        scan.merge_epilogue_scan(key, torch.zeros(8), 0, n_cols=4, sentinel_row=4)


def random_tables(tile_a, ntasks=40, nblocks=16, seed=0):
    """Every mask case: full tasks, short A slices, lane edges, an empty
    lane range, and zero padding tasks; keys that wrap at m·n = 2³²."""
    rng = np.random.default_rng(seed + tile_a)
    real = ntasks - 8
    tasks = np.zeros((ntasks, 4), np.int32)
    b_lo = rng.integers(0, 64, size=real)
    b_hi = rng.integers(64, 129, size=real)
    b_lo[:2], b_hi[:2] = 0, 128
    b_lo[2], b_hi[2] = 40, 40
    tasks[:real] = np.stack(
        [rng.integers(1, tile_a + 1, size=real), rng.integers(0, nblocks, size=real), b_lo, b_hi], 1
    )
    tasks[0, 0] = tile_a
    return [
        torch.from_numpy(x)
        for x in (
            tasks.reshape(-1),
            rng.integers(0, 65536, size=(ntasks, tile_a)).astype(np.int32),
            rng.normal(size=(ntasks, tile_a)).astype(np.float32),
            rng.integers(0, 65536, size=(nblocks, 128)).astype(np.int32),
            rng.normal(size=(nblocks, 128)).astype(np.float32),
        )
    ]


def assert_bit_equal(got, want):
    for g, w in zip(got, want):
        g = g.view(torch.int32) if g.dtype == torch.float32 else g
        w = w.view(torch.int32) if w.dtype == torch.float32 else w
        assert torch.equal(g, w)


def k3_k4_match_plain(args, tile_a, n_cols, sentinel_row):
    before = (expand.KERNEL_PACKED.launches, expand.KERNEL_COORDS.launches)
    got_p = expand.expand_tiles_packed(*args, tile_a=tile_a, n_cols=n_cols)
    got_c = expand.expand_tiles_coords(*args, tile_a=tile_a, sentinel_row=sentinel_row)
    want_p = expand.expand_tiles_packed_plain(*args, tile_a=tile_a, n_cols=n_cols)
    want_c = expand.expand_tiles_coords_plain(*args, tile_a=tile_a, sentinel_row=sentinel_row)
    torch.cuda.synchronize()
    assert (expand.KERNEL_PACKED.launches, expand.KERNEL_COORDS.launches) == (before[0] + 1, before[1] + 1)
    assert_bit_equal(got_p, want_p)
    assert_bit_equal(got_c, want_c)


@pytest.mark.parametrize("tile_a", [8, 32, 128])
def test_k3_k4_kernels_bit_equal_to_plain(cuda, tile_a):
    args = [t.to(cuda) for t in random_tables(tile_a)]
    k3_k4_match_plain(args, tile_a, 65536, 65536)


def test_k3_k4_kernels_bit_equal_on_a_plan(cuda):
    g = rmat(10, edge_factor=16, seed=1)
    tplan = plan_tiled(g.to_csc(), g.to_csr(), waste_limit=2.0, device=cuda)
    tables = tplan.class_tables()
    assert {s.tile_a for s, _ in tables} == {8, 32, 128}
    for sched, d in tables:
        args = [d[k] for k in ("tasks", "a_rows_t", "a_vals_t", "b_cols_blk", "b_vals_blk")]
        k3_k4_match_plain(args, sched.tile_a, tplan.n, tplan.m)


@pytest.mark.parametrize("packed", [None, False])
@pytest.mark.parametrize(
    "make",
    [
        lambda: (rmat(12, edge_factor=8, seed=5),) * 2,
        lambda: (rmat(10, edge_factor=16, seed=1),) * 2,
        lambda: (erdos_renyi(70_000, 70_000, 2e-5, seed=6),) * 2,
        big_shape_pair,
    ],
    ids=["rmat12", "rmat10_ef16", "er70k", "big_shape"],
)
def test_tiles_on_card_match_scipy(cuda, make, packed):
    a, b = make()
    got = spgemm(a, b, strategy="tiles", packed=packed, device=cuda)
    assert_csr_allclose(got, spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def test_unsplit_big_plan_on_card_runs_k4_and_flat_residue(cuda):
    a, b = big_shape_pair(seed=2)
    tplan = plan_tiled(a.to_csc(), b.to_csr(), device=cuda)
    assert tplan.light_plan is not None and tplan.class_tables()
    before = expand.KERNEL_COORDS.launches
    got = spgemm_padded_tiled(tplan).to_csr()
    assert expand.KERNEL_COORDS.launches == before + len(tplan.class_tables())
    assert_csr_allclose(got, spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def test_tiles_corner_2e32_on_card(cuda):
    a = COO((65536, 2), [65535, 3], [0, 1], [1.5, 2.0])
    b = COO((2, 65536), [0, 1], [65535, 7], [2.0, 1.0])
    assert_csr_allclose(spgemm(a, b, strategy="tiles", device=cuda), spgemm_scipy(a, b), rtol=RTOL, atol=ATOL)


def random_blockell(m, k, density, seed, block=(8, 128), empty_rows=()):
    """A random W as block-ELL (ragged rows, so masked slots) and dense."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((m, k)).astype(np.float32)
    d[rng.random((m, k)) >= density] = 0.0
    for r in empty_rows:
        d[r] = 0.0
    return BlockELL.from_coo(COO.from_dense(d), block_shape=block), d


@pytest.mark.parametrize(
    "m,k,n,density,block,tn",
    [
        (1000, 784, 1024, 0.01, (8, 128), 128),  # MLP1w layer 0's shapes
        (100, 784, 77, 0.05, (8, 128), 128),  # N not a multiple of 128
        (64, 256, 300, 0.002, (8, 128), 64),  # many masked slots and empty row blocks
        (37, 200, 50, 0.1, (16, 8), 32),  # bn = 8, two row groups per block
        (21, 300, 256, 0.1, (5, 128), 256),  # bm not a multiple of 8
    ],
)
def test_k5_kernel_matches_plain(cuda, m, k, n, density, block, tn):
    bm = block[0]
    w, d = random_blockell(m, k, density, seed=m + n, block=block, empty_rows=range(bm, 2 * bm))
    assert not w.block_mask.all()
    dev = spmm.blockell_to_device(w, cuda)
    x = np.random.default_rng(n).standard_normal((k, n)).astype(np.float32)
    k_pad = -(-k // block[1]) * block[1]
    xp = torch.zeros((k_pad, -(-n // tn) * tn), device=cuda)
    xp[:k, :n] = torch.from_numpy(x).to(cuda)
    before = spmm.KERNEL.launches
    got = spmm.spmm_blockell_device(dev["meta"], dev["blocks"], xp, tn=tn)[:m, :n]
    torch.cuda.synchronize()
    assert spmm.KERNEL.launches == before + 1
    want = spmm.spmm_blockell_plain(dev["meta"], dev["blocks"], xp)[:m, :n]
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale
    assert np.abs(got.cpu().numpy() - d.astype(np.float64) @ x).max() <= 1e-6 * scale
    assert not got[bm:2 * bm].any()


def test_k5_empty_w_writes_zeros(cuda):
    w = BlockELL.from_coo(COO((64, 128), [], [], []), block_shape=(8, 128))
    y = spmm.spmm(w, torch.ones((128, 32)), device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(y, torch.zeros((64, 32), device=cuda))


def test_k5_wrapper_rejects_mixed_devices_and_unsupported_shapes(cuda):
    w, _ = random_blockell(16, 256, 0.1, seed=1)
    dev = spmm.blockell_to_device(w, cuda)
    x = torch.zeros((256, 128), device=cuda)
    with pytest.raises(ValueError, match="x on cpu"):
        spmm.spmm_blockell_device(dev["meta"], dev["blocks"], x.cpu())
    with pytest.raises(ValueError, match="meta on cpu"):
        spmm.spmm_blockell_device(dev["meta"].cpu(), dev["blocks"], x)
    for tn in (48, 512):
        with pytest.raises(ValueError, match="K5 takes tn"):
            spmm.spmm_blockell_device(dev["meta"], dev["blocks"], torch.zeros((256, 1536), device=cuda), tn=tn)
    before = spmm.KERNEL.launches
    with pytest.raises(ValueError, match="bn | K_pad"):
        spmm.spmm_blockell_device(dev["meta"], dev["blocks"], torch.zeros((200, 128), device=cuda))
    assert spmm.KERNEL.launches == before


def weights(name):
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "saved_weights")
    return load_params(os.path.join(root, name))


@pytest.mark.parametrize(
    "model_type,path,batch,per_call",
    [("MLP1w", "MLP1w/prune0p01_finetuned.pkl", 256, 3), ("MLP1", "MLP1/pruned10_finetuned.pkl", 33, 3),
     ("LeNet", "LeNet/pruned_finetuned", 64, 5)],
)
def test_sparse_models_on_card_match_dense(cuda, model_type, path, batch, per_call):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    p = weights(path)
    x = synthetic_mnist(10 * batch, seed=1)["test"][0][:batch]
    dense = make_model(model_type).to(cuda)
    dense.load_state_dict(state_dict_from_params(p))
    cls = SparseLeNet if model_type == "LeNet" else SparseMLP
    model = cls(p, device=cuda)
    before = spmm.KERNEL.launches
    got = model(x)
    torch.cuda.synchronize()
    assert spmm.KERNEL.launches == before + per_call
    with torch.no_grad():
        want = dense(torch.from_numpy(x).to(cuda))[0]
    err = float((got - want).abs().max() / want.abs().max())
    assert err < 1e-5, err
