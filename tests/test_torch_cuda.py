"""The port's CUDA kernels on the card, against their plain versions and
scipy. Marked ``cuda``: each test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it runs on a machine without
them:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.formats import COO, erdos_renyi, rmat
from outerspace_tpu_torch.ops import assert_csr_allclose, spgemm, spgemm_scipy
from outerspace_tpu_torch.ops.gather_pipeline import plan_spgemm_gather
from outerspace_tpu_torch.ops.kernels import gexpand, scan

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
