"""The port's native host routines, loaded with ``ctypes``: the Matrix
Market reader (``csrc/mtx_reader.cpp``) and the CPU reference SpGEMM
(``csrc/ref_spgemm.cpp``), each built with ``g++`` into ``build/`` at
first use (``runtime.build.host_library``). A failed build raises, and so
does a failure of either routine: nothing falls back to Python here.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from outerspace_tpu_torch.runtime.build import host_library

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_F32P = ctypes.POINTER(ctypes.c_float)


def _mtx_library() -> ctypes.CDLL:
    lib = host_library("mtx_reader")
    lib.osp_mtx_read.restype = ctypes.c_void_p
    lib.osp_mtx_read.argtypes = [ctypes.c_char_p, ctypes.c_int]
    for fn in (lib.osp_mtx_nrows, lib.osp_mtx_ncols, lib.osp_mtx_nnz):
        fn.restype = ctypes.c_int64
        fn.argtypes = [ctypes.c_void_p]
    lib.osp_mtx_copy.restype = None
    lib.osp_mtx_copy.argtypes = [ctypes.c_void_p, _I32P, _I32P, _F32P]
    lib.osp_mtx_free.restype = None
    lib.osp_mtx_free.argtypes = [ctypes.c_void_p]
    return lib


def _ref_library() -> ctypes.CDLL:
    lib = host_library("ref_spgemm")
    lib.osp_ref_spgemm.restype = ctypes.c_void_p
    lib.osp_ref_spgemm.argtypes = [ctypes.c_int64] * 3 + [_I64P, _I32P, _F32P] * 2
    lib.osp_ref_nnz.restype = ctypes.c_int64
    lib.osp_ref_nnz.argtypes = [ctypes.c_void_p]
    lib.osp_ref_copy.restype = None
    lib.osp_ref_copy.argtypes = [ctypes.c_void_p, _I64P, _I32P, _F32P]
    lib.osp_ref_free.restype = None
    lib.osp_ref_free.argtypes = [ctypes.c_void_p]
    return lib


def read_mtx_native(path: str, expand_symmetric: bool = True):
    """A plain (not compressed) ``.mtx`` file as a COO, parsed by the C++
    reader. Raises FileNotFoundError for a missing file and OSError when
    the reader refuses the file (a bad header, an index out of range)."""
    from outerspace_tpu_torch.formats.coo import COO

    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    lib = _mtx_library()
    handle = lib.osp_mtx_read(os.fsencode(path), 1 if expand_symmetric else 0)
    if not handle:
        raise OSError(f"the native Matrix Market reader refused {path}")
    try:
        nnz = lib.osp_mtx_nnz(handle)
        rows = np.empty(nnz, dtype=np.int32)
        cols = np.empty(nnz, dtype=np.int32)
        vals = np.empty(nnz, dtype=np.float32)
        lib.osp_mtx_copy(handle, rows.ctypes.data_as(_I32P), cols.ctypes.data_as(_I32P),
                         vals.ctypes.data_as(_F32P))
        shape = (int(lib.osp_mtx_nrows(handle)), int(lib.osp_mtx_ncols(handle)))
    finally:
        lib.osp_mtx_free(handle)
    return COO(shape, rows, cols, vals)


def ref_spgemm_native(a_csc, b_csr):
    """C = A @ B on the host by the C++ outer-product reference, from A
    in CSC and B in CSR; returns a CSR (columns sorted within rows,
    duplicates summed in float32)."""
    from outerspace_tpu_torch.formats.csr import CSR

    if a_csc.shape[1] != b_csr.shape[0]:
        raise ValueError(f"inner dimensions differ: {a_csc.shape} @ {b_csr.shape}")
    lib = _ref_library()
    m, k = a_csc.shape
    n = b_csr.shape[1]
    ai = np.ascontiguousarray(a_csc.indptr, dtype=np.int64)
    ar = np.ascontiguousarray(a_csc.indices, dtype=np.int32)
    av = np.ascontiguousarray(a_csc.data, dtype=np.float32)
    bi = np.ascontiguousarray(b_csr.indptr, dtype=np.int64)
    bc = np.ascontiguousarray(b_csr.indices, dtype=np.int32)
    bv = np.ascontiguousarray(b_csr.data, dtype=np.float32)
    h = lib.osp_ref_spgemm(m, n, k, ai.ctypes.data_as(_I64P), ar.ctypes.data_as(_I32P),
                           av.ctypes.data_as(_F32P), bi.ctypes.data_as(_I64P),
                           bc.ctypes.data_as(_I32P), bv.ctypes.data_as(_F32P))
    if not h:
        raise RuntimeError("the native reference SpGEMM returned no result")
    try:
        nnz = lib.osp_ref_nnz(h)
        indptr = np.empty(m + 1, dtype=np.int64)
        cols = np.empty(nnz, dtype=np.int32)
        vals = np.empty(nnz, dtype=np.float32)
        lib.osp_ref_copy(h, indptr.ctypes.data_as(_I64P), cols.ctypes.data_as(_I32P),
                         vals.ctypes.data_as(_F32P))
    finally:
        lib.osp_ref_free(h)
    return CSR((m, n), indptr, cols, vals)
