"""K3 and K4 over a row part's class tables at once (``TileGroup``,
``expand_part_packed`` / ``expand_part_coords``) and the tiled part
stream written in place, on the CPU, against the JAX package.

- The grouped plain versions are bit-equal to the JAX package's
  ``expand_tiles_packed`` / ``expand_tiles_coords`` (Pallas, interpret
  mode) over the same class tables, joined in class order; they write
  the group's slots and nothing past them.
- A tiled part's stream (``tiled_expand_packed``: the classes, K1's
  residue, a light residue and the sentinel tail, written into one
  buffer) and its ``pad_count`` are bit-equal to the JAX package's
  ``tiled_expand_packed`` pieces joined and padded to ``merge_pad``.
- The descriptor of a plan carried from the JAX package equals the one
  the port's planner builds.
- The grouped wrappers refuse what the kernel does not take.

No reduction runs, so keys, rows, cols and values must be bit-equal.
Inputs are made with numpy from a seed.
"""

import dataclasses
import functools
import importlib

import numpy as np
import pytest
import torch

from outerspace_tpu.formats import COO, rmat
from outerspace_tpu.ops.pallas import expand as jexp
from outerspace_tpu.sched import autotune as jat
from outerspace_tpu_torch.convert import csc_from_arrays, csr_from_arrays, tiled_plan_from_arrays
from outerspace_tpu_torch.ops.kernels import expand as texp
from outerspace_tpu_torch.sched import autotune as tat
from outerspace_tpu_torch.sched.planner import TILE_A_CLASSES

import torch_cases  # tests/ is on sys.path under pytest

jsp = importlib.import_module("outerspace_tpu.ops.spgemm")
tsp = importlib.import_module("outerspace_tpu_torch.ops.spgemm")
big_shape_pair = functools.partial(torch_cases.big_shape_pair, COO)
dense_blocks = functools.partial(torch_cases.dense_blocks, COO)
M = N = 65536  # m·n = 2³²: biased keys use every bit and wrap
MARK = 12345  # what the output holds past the group's slots


@pytest.fixture(autouse=True)
def jax_weights(monkeypatch):
    torch_cases.set_jax_cost_weights(monkeypatch, jat, tat, TILE_A_CLASSES)


def class_table(tile_a, ntasks, rng, nblocks):
    """One class's host table: every mask case (full tasks, a_len <
    tile_a, b_lo > 0, b_hi < 128, an empty lane range, a one-lane range)
    and three padding tasks (all zero) at the end."""
    real = max(ntasks - 3, 0)
    tasks = np.zeros((ntasks, 4), np.int32)
    if real:
        b_lo = rng.integers(0, 64, size=real)
        b_hi = rng.integers(64, 129, size=real)
        b_lo[0], b_hi[0] = 0, 128
        if real > 3:
            b_lo[2], b_hi[2] = 40, 40
            b_lo[3], b_hi[3] = 5, 6
        a_len = rng.integers(1, tile_a + 1, size=real)
        a_len[0] = tile_a
        tasks[:real] = np.stack([a_len, rng.integers(0, nblocks, size=real), b_lo, b_hi], 1)
    a_rows_t = rng.integers(0, M, size=(ntasks, tile_a)).astype(np.int32)
    if ntasks:
        a_rows_t[0, 0] = M - 1
    return dict(
        tasks=tasks.reshape(-1),
        a_rows_t=a_rows_t,
        a_vals_t=rng.normal(size=(ntasks, tile_a)).astype(np.float32),
    )


def random_group(layout, seed, nblocks=16):
    """Host class tables of ``layout`` = [(tile_a, tasks)] and B blocks."""
    rng = np.random.default_rng(seed)
    tables = [(ta, class_table(ta, t, rng, nblocks)) for ta, t in layout]
    b_cols = rng.integers(0, N, size=(nblocks, 128)).astype(np.int32)
    b_cols[0, :4] = N - 1
    b_vals = rng.normal(size=(nblocks, 128)).astype(np.float32)
    return tables, b_cols, b_vals


def bits(t):
    t = torch.as_tensor(np.array(t))
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def outputs(dtypes, n):
    return [torch.full((n,), MARK, dtype=dt) for dt in dtypes]


LAYOUTS = {
    "8": [(8, 24)],
    "32": [(32, 16)],
    "128": [(128, 8)],
    "128+8": [(128, 8), (8, 40)],
    "128+32+8": [(128, 8), (32, 16), (8, 24)],
    "empty_middle": [(128, 8), (32, 0), (8, 24)],
    "empty_first": [(128, 0), (32, 16)],
}


@pytest.mark.parametrize("kind", ["packed", "coords"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_grouped_plain_bit_equal_to_pallas(layout, kind):
    tables, b_cols, b_vals = random_group(LAYOUTS[layout], seed=len(layout))
    group = texp.stage_group(tables, b_cols, b_vals, "cpu")
    assert group.layout == LAYOUTS[layout]
    pieces = []
    for tile_a, h in tables:
        ntasks = h["tasks"].shape[0] // 4
        if not ntasks:
            continue
        args = (h["tasks"], h["a_rows_t"], h["a_vals_t"], b_cols, b_vals)
        if kind == "packed":
            pieces.append(jexp.expand_tiles_packed(
                *args, ntasks=ntasks, tile_a=tile_a, n_cols=N, interpret=True))
        else:
            pieces.append(jexp.expand_tiles_coords(
                *args, ntasks=ntasks, tile_a=tile_a, sentinel_row=M, interpret=True))
    want = [np.concatenate([np.asarray(p[i]) for p in pieces]) for i in range(len(pieces[0]))]
    extra = 1000
    if kind == "packed":
        outs = outputs((torch.int32, torch.float32), group.slots + extra)
        texp.expand_part_packed_plain(group, n_cols=N, out_keys=outs[0], out_vals=outs[1])
    else:
        outs = outputs((torch.int32, torch.int32, torch.float32), group.slots + extra)
        texp.expand_part_coords_plain(
            group, sentinel_row=M, out_rows=outs[0], out_cols=outs[1], out_vals=outs[2])
    for got, w in zip(outs, want):
        assert w.shape == (group.slots,)
        assert torch.equal(bits(got[:group.slots]), bits(w))
        assert (got[group.slots:] == MARK).all()  # nothing past the group


@pytest.mark.parametrize("layout", ["128+32+8", "empty_middle", "8"])
def test_grouped_wrappers_take_the_plain_version_on_cpu(layout):
    group = texp.stage_group(*random_group(LAYOUTS[layout], seed=3), "cpu")
    before = (texp.KERNEL_PACKED.launches, texp.KERNEL_COORDS.launches)
    got = outputs((torch.int32, torch.float32), group.slots)
    want = outputs((torch.int32, torch.float32), group.slots)
    texp.expand_part_packed(group, n_cols=N, out_keys=got[0], out_vals=got[1])
    texp.expand_part_packed_plain(group, n_cols=N, out_keys=want[0], out_vals=want[1])
    got_c = outputs((torch.int32, torch.int32, torch.float32), group.slots)
    want_c = outputs((torch.int32, torch.int32, torch.float32), group.slots)
    texp.expand_part_coords(group, sentinel_row=M, out_rows=got_c[0], out_cols=got_c[1],
                            out_vals=got_c[2])
    texp.expand_part_coords_plain(group, sentinel_row=M, out_rows=want_c[0],
                                  out_cols=want_c[1], out_vals=want_c[2])
    for g, w in zip(got + got_c, want + want_c):
        assert torch.equal(bits(g), bits(w))
    assert (texp.KERNEL_PACKED.launches, texp.KERNEL_COORDS.launches) == before


def test_group_tables_are_the_single_table_wrappers_inputs():
    tables, b_cols, b_vals = random_group(LAYOUTS["128+32+8"], seed=5)
    group = texp.stage_group(tables, b_cols, b_vals, "cpu")
    out = outputs((torch.int32, torch.float32), group.slots)
    texp.expand_part_packed(group, n_cols=N, out_keys=out[0], out_vals=out[1])
    for c, (tile_a, h) in enumerate(tables):
        t = group.table(c)
        for key in ("tasks", "a_rows_t", "a_vals_t"):
            np.testing.assert_array_equal(t[key].numpy(), h[key])
        keys, vals = texp.expand_tiles_packed(*t.values(), tile_a=tile_a, n_cols=N)
        o = int(group.desc[c, 4])
        assert torch.equal(keys, out[0][o:o + keys.shape[0]])
        assert torch.equal(bits(vals), bits(out[1][o:o + vals.shape[0]]))


def test_group_descriptor_rows():
    desc = texp.group_descriptor([(128, 3), (32, 0), (8, 5)])
    # tile_a, tasks, first task, first A element, first slot, first unit
    np.testing.assert_array_equal(desc, [
        [128, 3, 0, 0, 0, 0],
        [32, 0, 3, 384, 3 * 128 * 128, 48],
        [8, 5, 3, 384, 3 * 128 * 128, 48],
    ])
    assert desc.dtype == np.int32
    with pytest.raises(ValueError, match="tile_a"):
        texp.group_descriptor([(12, 4)])
    with pytest.raises(ValueError, match="classes"):
        texp.group_descriptor([(8, 1)] * 4)
    with pytest.raises(ValueError, match="int32"):
        texp.group_descriptor([(128, 2**31 // (128 * 128))])


def test_grouped_wrappers_check_their_inputs():
    tables, b_cols, b_vals = random_group(LAYOUTS["128+8"], seed=2)
    group = texp.stage_group(tables, b_cols, b_vals, "cpu")
    keys, vals = outputs((torch.int32, torch.float32), group.slots)
    ok = dict(n_cols=N, out_keys=keys, out_vals=vals)
    with pytest.raises(ValueError, match="holds"):
        texp.expand_part_packed(group, n_cols=N, out_keys=keys[:-1], out_vals=vals)
    with pytest.raises(TypeError):
        texp.expand_part_packed(group, n_cols=N, out_keys=keys.float(), out_vals=vals)
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros((group.slots, 2), dtype=torch.int32)
        texp.expand_part_packed(group, n_cols=N, out_keys=wide[:, 0], out_vals=vals)
    with pytest.raises(ValueError, match="n_cols"):
        texp.expand_part_packed(group, n_cols=2**31, out_keys=keys, out_vals=vals)
    with pytest.raises(ValueError, match="sentinel_row"):
        texp.expand_part_coords(group, sentinel_row=-1, out_rows=keys, out_cols=keys.clone(),
                                out_vals=vals)
    bad = {
        "desc": dict(desc=group.desc[::-1].copy()),
        "tasks": dict(tasks=group.tasks[:-4]),
        "a_rows": dict(a_rows=group.a_rows[1:]),
        "b_vals_blk": dict(b_vals_blk=group.b_vals_blk[:-1]),
    }
    for name, change in bad.items():
        with pytest.raises(ValueError):
            texp.expand_part_packed(dataclasses.replace(group, **change), **ok)
    with pytest.raises(TypeError):
        texp.expand_part_packed(dataclasses.replace(group, a_vals=group.a_rows), **ok)
    with pytest.raises(TypeError, match="desc"):
        texp.expand_part_packed(dataclasses.replace(group, desc=group.desc.tolist()), **ok)
    meta = texp.TileGroup(group.desc, *(t.to("meta") for t in (
        group.tasks, group.a_rows, group.a_vals, group.b_cols_blk, group.b_vals_blk)))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        texp.expand_part_packed(meta, n_cols=N, out_keys=keys.to("meta"),
                                out_vals=vals.to("meta"))
    with pytest.raises(ValueError, match="is on"):
        texp.expand_part_packed(meta, **ok)


# ---- the part stream in place, against the JAX package's pieces ----------


def port(a, b):
    a_csc, b_csr = a.to_csc(), b.to_csr()
    return (
        csc_from_arrays(a_csc.shape, a_csc.indptr, a_csc.indices, a_csc.data),
        csr_from_arrays(b_csr.shape, b_csr.indptr, b_csr.indices, b_csr.data),
    )


def parts_of(plan):
    if hasattr(plan, "parts"):
        return [p for _, _, p in plan.parts], plan.merge_pad or None
    return [plan], None


def assert_streams_equal(jplan, tplan):
    """Every part's in-place stream equal to the JAX pieces joined and
    sentinel-padded to ``merge_pad``, with the same ``pad_count``."""
    jparts, merge_pad = parts_of(jplan)
    tparts, _ = parts_of(tplan)
    assert len(jparts) == len(tparts)
    for jp, tp in zip(jparts, tparts):
        jk, jv, jpad = jsp.tiled_expand_packed(jp, interpret=True)
        jk = np.concatenate([np.asarray(k) for k in jk])
        jv = np.concatenate([np.asarray(v) for v in jv])
        extra = 0 if merge_pad is None else merge_pad - jk.shape[0]
        assert extra >= 0
        jk = np.concatenate([jk, np.full(extra, 2**31 - 1, np.int32)])
        jv = np.concatenate([jv, np.zeros(extra, np.float32)])
        tk, tv, tpad = tsp.tiled_expand_packed(tp, merge_pad)
        assert tpad == jpad + extra
        assert torch.equal(tk, bits(jk))
        assert torch.equal(bits(tv), bits(jv))


@pytest.mark.parametrize("waste_limit", [None, 2.0])
def test_part_stream_bit_equal_to_jax_zoo(operand_pair, waste_limit):
    a, b = operand_pair
    jplan = jsp.plan_tiled(a.to_csc(), b.to_csr(), waste_limit=waste_limit)
    assert_streams_equal(jplan, tiled_plan_from_arrays(jplan, device="cpu"))
    assert_streams_equal(jplan, tsp.plan_tiled(*port(a, b), waste_limit=waste_limit,
                                               device="cpu"))


STREAM_PLANS = {
    # row parts with tile tasks inside, commonised to merge_pad
    "forced4": (lambda: (rmat(9, edge_factor=16, seed=1),) * 2,
                dict(nparts=4, min_part_stream=1, budget=10.0)),
    "dense_blocks": (dense_blocks, dict(waste_limit=2.0)),
    # m·n > 2³²: rebased row parts (gather residues in part-local keys),
    # commonised, and with per-part lengths (merge_pad 0; one part has
    # no tile class)
    "rebased": (lambda: big_shape_pair(seed=2), {}),
    "rebased_uncommon": (lambda: big_shape_pair(seed=1), {}),
}


@pytest.mark.parametrize("name", sorted(STREAM_PLANS))
def test_part_stream_bit_equal_to_jax_parts(name):
    make, kw = STREAM_PLANS[name]
    a, b = make()
    jplan = jsp.plan_tiled_parts(a.to_csc(), b.to_csr(), **kw)
    tplan = tiled_plan_from_arrays(jplan, device="cpu")
    if name != "dense_blocks":
        assert isinstance(tplan, tsp.TiledPartsPlan)
        assert bool(tplan.merge_pad) == (name != "rebased_uncommon")
        assert tplan.rebased == name.startswith("rebased")
    assert any(p.group is not None for p in parts_of(tplan)[0])
    assert_streams_equal(jplan, tplan)


def test_part_stream_with_a_light_residue_bit_equal_to_jax():
    # unsplit m·n > 2³²: the flat expand's light residue follows the classes
    a, b = big_shape_pair(seed=2)
    jplan = jsp.plan_tiled(a.to_csc(), b.to_csr())
    tplan = tiled_plan_from_arrays(jplan, device="cpu")
    assert tplan.light_plan is not None and tplan.group is not None
    assert_streams_equal(jplan, tplan)
    keys, _, pad = tsp.tiled_expand_packed(tplan, tplan.padded_total + 4096)
    assert (keys[-4096:] == 2**31 - 1).all() and pad == tsp.tiled_pad_count(tplan) + 4096
    with pytest.raises(ValueError, match="merge_pad"):
        tsp.tiled_expand_packed(tplan, tplan.padded_total - 1)


@pytest.mark.parametrize("name", sorted(STREAM_PLANS))
def test_descriptor_of_a_carried_plan_equals_the_planned_one(name):
    make, kw = STREAM_PLANS[name]
    a, b = make()
    carried = tiled_plan_from_arrays(jsp.plan_tiled_parts(a.to_csc(), b.to_csr(), **kw),
                                     device="cpu")
    planned = tsp.plan_tiled_parts(*port(a, b), device="cpu", **kw)
    cparts, pparts = parts_of(carried)[0], parts_of(planned)[0]
    assert len(cparts) == len(pparts)
    for cp, pp in zip(cparts, pparts):
        assert (cp.group is None) == (pp.group is None)
        if cp.group is None:
            continue
        np.testing.assert_array_equal(cp.group.desc, pp.group.desc)
        assert cp.group.desc.dtype == pp.group.desc.dtype == np.int32
        for f in ("tasks", "a_rows", "a_vals", "b_cols_blk", "b_vals_blk"):
            assert torch.equal(bits(getattr(cp.group, f)), bits(getattr(pp.group, f))), f
        # the per-class tables are views of the group
        live = [c for c in pp.class_plan.classes if c.ntasks]
        assert pp.group.layout == [(c.tile_a, c.ntasks_padded) for c in live]
        for (_, d), c in zip(pp.class_tables(), range(len(live))):
            assert d["tasks"].data_ptr() == pp.group.table(c)["tasks"].data_ptr()
