"""K1's plain version vs the JAX package's Pallas windowed-gather expand
(interpret mode) on windows made by hand rather than planned: ``cum``
that runs at random or is all zero (so the owner is what the search
finds, not the true owner), reads clamped past the packs' last ref, keys
past 2³², padding groups. The plain version is the function the CUDA
kernel must match bit for bit (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch

from outerspace_tpu.ops.pallas.gexpand import expand_gather_packed
from outerspace_tpu_torch.ops.kernels.gexpand import expand_gather, expand_gather_plain

import torch_cases  # tests/ is on sys.path under pytest

I32_MAX = 2**31 - 1


@pytest.mark.parametrize(
    "b_win,bits,shift",
    # the last: jb, cum and p0 near 3·2^28, large but (unlike 2^30, where
    # the Pallas kernel's int32 offsets wrap) summing below 2^31
    [(3, 4, 0), (3, 6, 0), (3, 8, 0), (5, 4, 0), (5, 6, 0), (5, 8, 0), (5, 6, 3 * 2**28)],
)
def test_k1_plain_matches_pallas_on_odd_windows(b_win, bits, shift):
    h = torch_cases.k1_odd_windows(seed=10 * bits + b_win, b_win=b_win, bits=bits, shift=shift)
    cum = h["a_pack"][:, :, 3]
    assert (np.diff(cum, axis=-1) < 0).any() and (cum == 0).all(axis=-1).any()
    kj, vj = expand_gather_packed(
        h["bases"], h["table"], h["a_pack"], h["b_pack"],
        ngroups=h["table"].shape[0], b_win=b_win, search_bits=bits, interpret=True,
    )
    t = {k: torch.from_numpy(v) for k, v in h.items()}
    kt, vt = expand_gather(t["bases"], t["table"], t["a_pack"], t["b_pack"],
                           t["group_bits"], b_win=b_win)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj).reshape(-1))
    np.testing.assert_array_equal(vt.numpy().view(np.int32), np.asarray(vj).reshape(-1).view(np.int32))
    live = h["table"][:, :, 3].reshape(-1, 1) > np.arange(1024)
    assert (kt.numpy().reshape(live.shape)[~live] == I32_MAX).all()
    assert (kt.numpy().reshape(live.shape)[live] != I32_MAX).any()


def _check_against_scalar_walk(h, b_win):
    """The plain version on ``h`` against a scalar walk of the search and
    the gathers, 16 slots of each subtile. Python's and numpy's negative
    indices wrap once, as torch's do."""
    t = {k: torch.from_numpy(v) for k, v in h.items()}
    kt, vt = expand_gather_plain(t["bases"], t["table"], t["a_pack"], t["b_pack"],
                                 t["group_bits"], b_win=b_win)
    a = h["a_pack"].reshape(-1)
    b = h["b_pack"].reshape(-1)
    nab8, nbb8 = h["a_pack"].shape[0], h["b_pack"].shape[0]
    rng = np.random.default_rng(0)
    for g in range(h["table"].shape[0]):
        a8, b8 = (int(x) for x in h["bases"][2 * g:2 * g + 2])
        bits = int(h["group_bits"][g])
        for s in range(8):
            r_a, r_b, p0, plen, _, n_cols, anchor = (int(x) for x in h["table"][g, s, :7])

            def a_field(e, f):
                la = r_a + (e >> 7)
                blk = min(a8 + (la >> 3), nab8 - 1) * 8 + (la & 7)
                return int(a[(blk * 4 + f) * 128 + (e & 127)])

            for slot in rng.integers(0, 1024, size=16):
                i = (g * 8 + s) * 1024 + int(slot)
                if slot >= plen:
                    assert int(kt[i]) == I32_MAX and float(vt[i]) == 0.0
                    continue
                p = p0 + int(slot)
                ow = 0 if bits >= 8 else anchor
                for bit in range(min(bits, 8) - 1, -1, -1):
                    if a_field(ow + (1 << bit), 3) <= p:
                        ow += 1 << bit
                jloc = a_field(ow, 2) + p - a_field(ow, 3) - (b8 * 8 + r_b) * 128
                jloc = min(max(jloc, 0), b_win * 128 - 1)
                lb = r_b + (jloc >> 7)
                bi = (min(b8 + (lb >> 3), nbb8 - 1) * 8 + (lb & 7)) * 256 + (jloc & 127)
                key = (a_field(ow, 0) * n_cols + int(b[bi]) - 2**31) % 2**32
                assert int(kt[i]) % 2**32 == key
                val = np.float32(np.int32(a_field(ow, 1)).view(np.float32)) * np.int32(b[bi + 128]).view(np.float32)
                assert vt[i].numpy().view(np.int32) == np.float32(val).view(np.int32)


def test_k1_plain_odd_windows_mixed_depths_out_of_window():
    # Per-group depths and anchors that send the search past the A
    # window (and below it): the plain version reads through the clamp,
    # as the CUDA kernel's out-of-window path does. The Pallas kernel
    # holds only its windows, so only the plain version is defined
    # there; check it against a scalar walk.
    h = torch_cases.k1_odd_windows(seed=3, b_win=5, bits=None, anchors=(-100, 300))
    _check_against_scalar_walk(h, 5)


def test_k1_plain_reads_before_the_packs_wrap():
    # Window ref 0 with negative anchors, and negative B window refs:
    # some reads fall before a pack's first block, and their indices
    # wrap once by the pack's length (the CUDA kernel does the same).
    h = torch_cases.k1_odd_windows(seed=1, b_win=5, bits=None, anchors=(-100, 0),
                                   r_a=(0, 2), r_b=(-8, 6))
    assert torch_cases.k1_reads_before_the_packs(h) == (True, True)
    _check_against_scalar_walk(h, 5)
