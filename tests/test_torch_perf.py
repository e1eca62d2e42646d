"""The port's perf modules on the CPU: the roofline's properties (as
``tests/test_perf.py`` checks the JAX package's) and its byte counts
against the tensors the port's pipeline allocates for a small plan; the
timers; the microbench suite at a small size."""

import contextlib
import io
import json
import math
import time

import numpy as np
import pytest
import torch

from outerspace_tpu_torch.formats import rmat
from outerspace_tpu_torch.ops.kernels.scan import merge_epilogue_plain
from outerspace_tpu_torch.ops.spgemm import (
    I32_MAX,
    _expand_light_packed,
    plan_to_device,
)
from outerspace_tpu_torch.ops.symbolic import expansion_plan
from outerspace_tpu_torch.perf import microbench, roofline
from outerspace_tpu_torch.perf.roofline import (
    GPUConfig,
    achieved_fraction,
    predict_mcl_time,
    predict_merge_time,
    predict_multiply_time,
    predict_sort_time,
    predict_spgemm_time,
)
from outerspace_tpu_torch.perf.timer import Timer, device_sync, profiler_trace, time_device, timed


def test_monotone_in_size():
    cfg = GPUConfig()
    t1 = predict_multiply_time(1 << 20, 1000, 1000, cfg)
    t2 = predict_multiply_time(1 << 24, 1000, 1000, cfg)
    assert t2 > t1 > 0
    assert predict_merge_time(1 << 24) > predict_merge_time(1 << 20) > 0
    assert predict_spgemm_time(1 << 24, 10, 10) > predict_spgemm_time(1 << 20, 10, 10)


def test_merge_dominates_multiply_and_sort():
    p = 1 << 24
    assert predict_merge_time(p) > predict_sort_time(p) > predict_multiply_time(p, 1000, 1000)
    assert predict_spgemm_time(p, 1000, 1000) == pytest.approx(
        predict_multiply_time(p, 1000, 1000) + predict_merge_time(p))


@pytest.mark.parametrize("p", [1 << 20, (1 << 24) + 3])
def test_merge_parts_monotone(p):
    # the radix sort is linear in its length: parts only add each
    # part's rounding up and its nnz word, never saving time
    one = predict_merge_time(p)
    times = [predict_merge_time(p, parts=k) for k in (2, 3, 5, 8, 64)]
    assert all(one <= t <= 1.01 * one for t in times)
    pow2 = [predict_merge_time(p, parts=k) for k in (1, 2, 4, 8)]
    assert all(b >= a for a, b in zip(pow2, pow2[1:]))
    bitonic = [predict_merge_time(p, parts=k, sort_impl="xla_bitonic") for k in (1, 4, 16)]
    assert all(b < a for a, b in zip(bitonic, bitonic[1:]))  # shorter networks


def test_radix_beats_bitonic_and_unknown_impl_raises():
    p = 1 << 26
    assert predict_merge_time(p) < predict_merge_time(p, sort_impl="xla_bitonic")
    with pytest.raises(ValueError):
        predict_merge_time(p, sort_impl="radix8")


def test_multi_device_waits_for_the_sharded_mode():
    # the sharded mode is ported: ndev > 1 predicts the most loaded rank
    # (tests/test_torch_perf_sharded.py checks the sharded predictors)
    even = predict_spgemm_time(1 << 20, 10, 10, ndev=2)
    assert math.isfinite(even) and even > 0
    skewed = predict_spgemm_time(1 << 20, 10, 10, ndev=2, per_device_products=[1 << 19, 3 << 18])
    assert skewed > even


def test_achieved_fraction_and_config():
    assert achieved_fraction(2.0, 1.0) == pytest.approx(0.5)
    assert achieved_fraction(0.0, 1.0) > 1e11
    cfg = GPUConfig()
    assert (cfg.hbm_bw_bytes, cfg.fp32_ops) == (3.35e12, 67e12)
    assert cfg.time(67e12, 1.0) == pytest.approx(1.0)
    assert cfg.time(0, 3.35e12) == pytest.approx(1.0)
    slow = GPUConfig(hbm_bw_bytes=1e12)
    assert predict_merge_time(1 << 20, slow) > predict_merge_time(1 << 20)


def test_smoke_bounds_read_the_roofline_config():
    import chip_smoke

    assert chip_smoke.HBM_BYTES_PER_S == GPUConfig().hbm_bw_bytes
    assert chip_smoke.FP32_OPS_PER_S == GPUConfig().fp32_ops


def test_mcl_model_grows_with_its_budgets():
    base = predict_mcl_time(1 << 20, (1 << 19,) * 3, 1 << 16)
    assert base > predict_spgemm_time(1 << 20, 1 << 16, 1 << 16)
    assert predict_mcl_time(1 << 20, (1 << 19,) * 4, 1 << 16) > base
    assert predict_mcl_time(1 << 20, (1 << 20,) * 3, 1 << 16) > base
    assert predict_mcl_time(1 << 20, (1 << 19,) * 3, 1 << 17) > base
    assert predict_mcl_time(1 << 20, (), 1 << 16) < base
    # a product budget below elem_pad is charged at elem_pad, as the loop runs it
    assert predict_mcl_time(1 << 20, (1,), 1 << 16) == predict_mcl_time(1 << 20, (1 << 16,), 1 << 16)


@pytest.mark.parametrize("seed", [1, 2])
def test_byte_counts_equal_the_pipeline_tensors(seed):
    """The roofline's bytes on a small flat plan equal the ``nbytes`` of
    what the port's pipeline reads and writes: the operands, the expand's
    stream, ``torch.sort``'s keys and int64 order, the gathered values,
    and K2's outputs."""
    a = rmat(7, edge_factor=8, seed=seed)
    a_csc, b_csr = a.to_csc(), a.to_csr()
    plan = expansion_plan(a_csc, b_csr)
    p_pad = plan.padded_size()
    key, val = _expand_light_packed(**plan_to_device(plan, "cpu"), p_pad=p_pad,
                                    sentinel_row=plan.m, n_cols=plan.n)
    assert key.numel() == p_pad
    operands = sum(x.nbytes for x in (a_csc.indices, a_csc.data, b_csr.indices, b_csr.data))
    assert roofline.multiply_bytes(p_pad, a.nnz, a.nnz) == key.nbytes + val.nbytes + operands
    skey, order = torch.sort(key)
    sval = val[order]
    sort = roofline.RADIX_PASSES * 2 * (skey.nbytes + order.nbytes) + (order.nbytes + val.nbytes
                                                                       + sval.nbytes)
    assert roofline.sort_bytes(p_pad) == sort
    out = merge_epilogue_plain(skey, sval, p_pad - plan.expansion_size, n_cols=plan.n,
                               sentinel_row=plan.m)
    epilogue = skey.nbytes + sval.nbytes + sum(t.nbytes for t in out)
    assert roofline.merge_bytes(p_pad) == sort + epilogue
    assert int(out[4]) > 0 and int((skey == I32_MAX).sum()) >= p_pad - plan.expansion_size


def test_timer_and_timed(capsys):
    with Timer("x", quiet=True) as t:
        time.sleep(0.01)
    assert t.elapsed >= 0.01

    @timed("cap")
    def f():
        return 7

    assert f() == 7
    assert "[cap]" in capsys.readouterr().err


def test_time_device_on_the_cpu():
    x = torch.arange(1 << 16, dtype=torch.float32)
    s = time_device(lambda: (x * 2).sum(), reps=3, warmup=1)
    assert 0 < s < 1
    slow = time_device(lambda: time.sleep(0.005), reps=2, warmup=1)  # no tensor: host clock
    assert slow >= 0.005
    device_sync({"a": [x, (x,)]})  # CPU tensors: nothing to wait for


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    with profiler_trace(str(tmp_path / "t")) as prof:
        torch.ones(64).cumsum(0)
    assert (tmp_path / "t" / "trace.json").stat().st_size > 0
    assert prof.key_averages()


def test_microbench_suite_small():
    res = microbench.suite(p=8192, e=2048, m=256, k=2, device="cpu")
    assert sorted(res) == sorted([
        "sort2_p", "merge_epilogue_sorted_p", "sort1_u64_p", "scatter_bcast_lane",
        "pair_gather_random", "pair_gather_sorted", "i32_gather_random",
        "two_single_gathers_random", "searchsorted_probes", "rank_trick_probes",
        "slice_fill_buckets"])
    assert all(math.isfinite(v) and v > 0 for v in res.values())


def test_microbench_main_prints_json():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert microbench.main(["--small", "--k", "1", "--device", "cpu"]) == 0
    out = json.loads(buf.getvalue())
    assert len(out) == 11 and all(np.isfinite(v) for v in out.values())
