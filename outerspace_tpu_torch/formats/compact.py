"""Regroupings of sparse matrices: ``CompactCOO`` and block-ELL.

``CompactCOO`` regroups a CSR by position within its row: group *j*
holds the *j*-th nonzero of every row that has more than *j*, an
interchange format checked by a round trip (``sanity_check``).

Block-ELL is the padded block-sparse layout of the SpMM kernel's
weights. Rows are tiled into ``bm``-high stripes; each stripe's nonzero column
blocks (``bn`` wide) are gathered and padded to the matrix's maximum, so
every array has a static shape. It is the operand layout of K5
(``ops/kernels/spmm.py``: sparse weights × dense activations). numpy,
array for array the JAX package's ``formats/compact.py:BlockELL`` for
the same COO.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from outerspace_tpu_torch.formats.coo import COO, INDEX_DTYPE, VALUE_DTYPE
from outerspace_tpu_torch.formats.csr import CSR


@dataclasses.dataclass
class CompactCOO:
    """Row-position-grouped COO: ``groups[j]`` is the (rows, cols, vals)
    triple of the *j*-th nonzero of every row with nnz > j, rows
    ascending (array for array the JAX package's ``CompactCOO``)."""

    shape: tuple[int, int]
    groups: list[tuple[np.ndarray, np.ndarray, np.ndarray]]

    @property
    def nnz(self) -> int:
        return int(sum(g[0].shape[0] for g in self.groups))

    @classmethod
    def from_csr(cls, m: CSR) -> "CompactCOO":
        row_nnz = m.major_nnz()
        groups = []
        for j in range(int(row_nnz.max(initial=0))):
            rows = np.nonzero(row_nnz > j)[0].astype(INDEX_DTYPE)
            idx = np.asarray(m.indptr[rows], dtype=np.int64) + j
            groups.append((rows, m.indices[idx], m.data[idx]))
        return cls(m.shape, groups)

    def to_coo(self) -> COO:
        """The entries group by group (not sorted)."""
        if not self.groups:
            e = np.zeros(0, dtype=INDEX_DTYPE)
            return COO(self.shape, e, e, np.zeros(0, dtype=VALUE_DTYPE))
        return COO(self.shape, *(np.concatenate([g[i] for g in self.groups]) for i in range(3)))

    def sanity_check(self, original: CSR, eps: float = 1e-6) -> bool:
        """Whether the round trip gives ``original`` back
        (``ops.reference.compare_coo``, relative ``eps``)."""
        from outerspace_tpu_torch.ops.reference import compare_coo

        return compare_coo(self.to_coo(), original.to_coo(), eps=eps)


@dataclasses.dataclass
class BlockELL:
    """Padded block-ELL.

    Attributes:
      shape:        logical (M, N) of the sparse matrix.
      block_shape:  (bm, bn) dense block size.
      block_cols:   int32[num_row_blocks, max_blocks] — column-block index of
                    each stored block, padded with 0.
      block_mask:   bool[num_row_blocks, max_blocks] — validity of each slot.
      blocks:       f32[num_row_blocks, max_blocks, bm, bn] — dense block
                    payloads, zero-padded.
    """

    shape: tuple[int, int]
    block_shape: tuple[int, int]
    block_cols: np.ndarray
    block_mask: np.ndarray
    blocks: np.ndarray

    @property
    def num_row_blocks(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def max_blocks_per_row(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def stored_blocks(self) -> int:
        return int(self.block_mask.sum())

    def density(self) -> float:
        """Fraction of logical block-grid slots that are stored."""
        total = self.num_row_blocks * -(-self.shape[1] // self.block_shape[1])
        return self.stored_blocks / max(total, 1)

    @classmethod
    def from_coo(
        cls,
        coo: COO,
        block_shape: tuple[int, int] = (128, 128),
        pad_blocks_to: int | None = None,
    ) -> "BlockELL":
        """Blocks of each row stripe in ascending block-column order;
        duplicate coordinates are summed."""
        bm, bn = block_shape
        m, n = coo.shape
        nrb = -(-m // bm)
        ncb = -(-n // bn)
        key = (coo.row // bm).astype(np.int64) * ncb + coo.col // bn
        order = np.argsort(key, kind="stable")
        skey = key[order]
        new = np.ones(skey.shape[0], dtype=bool)
        new[1:] = skey[1:] != skey[:-1]
        uniq_key = skey[new]
        ub_rb = uniq_key // ncb
        ub_cb = (uniq_key % ncb).astype(INDEX_DTYPE)
        counts = np.bincount(ub_rb, minlength=nrb)
        max_blocks = int(counts.max(initial=0))
        if pad_blocks_to is not None:
            max_blocks = max(max_blocks, pad_blocks_to)
        max_blocks = max(max_blocks, 1)

        # slot of each unique block within its row stripe: its rank among
        # the stripe's blocks (unique keys are sorted by stripe)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        slot_of_block = np.arange(uniq_key.shape[0]) - starts[ub_rb]
        block_cols = np.zeros((nrb, max_blocks), dtype=INDEX_DTYPE)
        block_mask = np.zeros((nrb, max_blocks), dtype=bool)
        block_cols[ub_rb, slot_of_block] = ub_cb
        block_mask[ub_rb, slot_of_block] = True

        blocks = np.zeros((nrb, max_blocks, bm, bn), dtype=VALUE_DTYPE)
        seg = np.cumsum(new) - 1  # unique block of each sorted element
        np.add.at(
            blocks,
            (ub_rb[seg], slot_of_block[seg],
             (coo.row[order] % bm).astype(np.int64), (coo.col[order] % bn).astype(np.int64)),
            coo.val[order],
        )
        return cls((m, n), (bm, bn), block_cols, block_mask, blocks)

    def to_dense(self) -> np.ndarray:
        bm, bn = self.block_shape
        m, n = self.shape
        pad = np.zeros((self.num_row_blocks * bm, -(-n // bn) * bn), dtype=VALUE_DTYPE)
        for i, s in zip(*np.nonzero(self.block_mask)):
            c = int(self.block_cols[i, s]) * bn
            pad[i * bm : (i + 1) * bm, c : c + bn] += self.blocks[i, s]
        return pad[:m, :n]

    def to_coo(self) -> COO:
        return COO.from_dense(self.to_dense())
