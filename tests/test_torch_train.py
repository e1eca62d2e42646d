"""The port's training pipeline (``nn/train.py``, the initialiser and the
batching in ``nn/models.py`` / ``nn/data.py``) against the JAX
package's on the CPU, from the same flax-initialised parameters carried
across with ``convert.state_dict_from_params``.

Bars, each set before the comparison:
- one step's loss and gradients, float32: loss within 1e-5, every
  gradient within 1e-6 absolute (gradients here are below ~0.05; the
  sums run in other orders);
- three Adam steps, float64 on both sides (``jax.enable_x64``): loss and
  every parameter within 1e-8 absolute. Float64 because Adam divides a
  gradient by its own running size: where a gradient is within rounding
  of zero, two float32 sums of it in other orders can step a weight by
  up to 2·lr apart, so float32 parameters after several steps need not
  agree to 1e-5 however right both steps are;
- one epoch of ``train``, float32: history and parameters within 1e-4;
- the learning-rate schedule: within 1e-7 relative of optax's value,
  step by step; ``shift_augment`` and ``batches``: bit-equal.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from outerspace_tpu.nn import data as jdata
from outerspace_tpu.nn import prune as jprune
from outerspace_tpu.nn import train as jt
from outerspace_tpu.nn.models import activation_sparsity as j_activation_sparsity
from outerspace_tpu.nn.models import make_model as jmake
from outerspace_tpu_torch.convert import load_params as flax_load, params_from_state_dict
from outerspace_tpu_torch.convert import state_dict_from_params
from outerspace_tpu_torch.nn import data, models, prune
from outerspace_tpu_torch.nn import train as tt


@pytest.fixture(scope="module")
def mnist():
    return data.synthetic_mnist(512, seed=0)


def flax_init(model_type, x, seed=0):
    return jmake(model_type).init(jax.random.PRNGKey(seed), jnp.asarray(x[:2]))["params"]


def as_state_dict(p, dtype=torch.float32):
    host = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    return {k: v.to(dtype) for k, v in state_dict_from_params(host).items()}


def as_numpy_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def tree_of(sd):
    """A state_dict in the flax layout, values as float64 numpy arrays."""
    out = {}
    for key, t in sd.items():
        prefix, i, kind = key.split(".")
        arr = t.detach().double().numpy()
        if kind == "weight":
            arr = np.transpose(arr, (2, 3, 1, 0) if arr.ndim == 4 else (1, 0))
        out.setdefault(f"{prefix.capitalize()}_{i}", {})["kernel" if kind == "weight" else "bias"] = arr
    return out


def max_param_diff(jax_params, sd) -> float:
    got, want = tree_of(sd), as_numpy_tree(jax_params)
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k][n] - want[k][n]).max()) for k in want for n in want[k])


CASES = {
    "MLP1": dict(model_type="MLP1"),
    "MLP1-l2reg": dict(model_type="MLP1", l2reg=True),
    "LeNet-l2reg": dict(model_type="LeNet", l2reg=True),
    "MLP1-finetune": dict(model_type="MLP1", finetune=True),
}


def case_params(fields, x):
    """Flax-initialised params for a case (pruned to 10% / 25% for the
    finetune case) and its JAX masks."""
    p = flax_init(fields["model_type"], x)
    if fields.get("finetune"):
        p = jprune.prune_params(p, 0.1)
    return p, jprune.nonzero_masks(p)


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_grads_equal_jax(case, mnist):
    fields = CASES[case]
    x, y = mnist["train"][0][:128], mnist["train"][1][:128]
    p, _ = case_params(fields, x)
    jcfg, tcfg = jt.TrainConfig(**fields), tt.TrainConfig(**fields)
    model = jmake(fields["model_type"])
    with jax.default_matmul_precision("float32"):
        (loss, (ce, acc)), grads = jax.value_and_grad(jt.loss_fn, has_aux=True)(
            p, model.apply, jnp.asarray(x), jnp.asarray(y), jcfg)
    tmodel = tt.load_model(fields["model_type"], as_state_dict(p), device="cpu")
    tloss, (tce, tacc) = tt.loss_fn(tmodel, torch.from_numpy(x), torch.from_numpy(y).long(), tcfg)
    tloss.backward()
    assert abs(tloss.item() - float(loss)) <= 1e-5
    assert abs(tce.item() - float(ce)) <= 1e-5
    assert float(tacc) == float(acc)
    tgrads = params_from_state_dict({k: v.grad for k, v in tmodel.named_parameters()})
    for k, layer in as_numpy_tree(grads).items():
        for n, g in layer.items():
            np.testing.assert_allclose(tgrads[k][n], g, rtol=0, atol=1e-6, err_msg=f"{k}/{n}")


def test_l2_pairs_in_flax_order():
    # LeNet: the three weight lambdas go to Conv_0, Conv_1, Dense_0 (fc2
    # and fc3 get none); the activation lambdas to conv1-out, pool1-out
    model = models.make_model("LeNet")
    got = [tuple(w.shape) for w in tt.kernels(model)]
    assert got == [(6, 1, 5, 5), (16, 6, 5, 5), (120, 400), (84, 120), (10, 84)]
    x = torch.rand(4, 28, 28)
    cfg = tt.TrainConfig(model_type="LeNet", l2reg=True, weight_lambdas=(1.0, 0.0, 0.0),
                         act_lambdas=(0.0, 1.0))
    with torch.no_grad():
        loss, (ce, _) = tt.loss_fn(model, x, torch.zeros(4, dtype=torch.long), cfg)
        pool1 = model(x)[1][1]
        want = (model.conv[0].weight ** 2).sum() + (pool1 ** 2).sum() / 4
    torch.testing.assert_close(loss - ce, want)


STEP_CASES = dict(CASES, **{"MLP1-cosine": dict(model_type="MLP1", lr_schedule="cosine",
                                                 num_epochs=1)})


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_three_steps_equal_jax(case, mnist):
    fields = dict(STEP_CASES[case], batch_size=128)
    x, y = mnist["train"][0][:128], mnist["train"][1][:128]
    jcfg, tcfg = jt.TrainConfig(**fields), tt.TrainConfig(**fields)
    p32, _ = case_params(fields, x)
    model = jmake(fields["model_type"])
    n_train = 512  # the cosine schedule of a 4-step epoch
    total = jcfg.num_epochs * n_train // jcfg.batch_size
    with jax.enable_x64(True):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), p32)
        masks = jprune.nonzero_masks(p)
        tx = optax.adam(optax.warmup_cosine_decay_schedule(
            init_value=jcfg.lr * 0.1, peak_value=jcfg.lr, warmup_steps=max(1, total // 20),
            decay_steps=total, end_value=jcfg.lr * 0.01) if jcfg.lr_schedule == "cosine" else jcfg.lr)
        state = tx.init(p)
        xj, yj = jnp.asarray(x, jnp.float64), jnp.asarray(y)
        jlosses = []
        for _ in range(3):
            p, state, loss, _ = jt.train_step(p, state, xj, yj, masks, apply_fn=model.apply,
                                              cfg=jcfg, tx=tx)
            jlosses.append(float(loss))
        p = as_numpy_tree(p)

    sd = as_state_dict(p32, torch.float64)
    tmodel = tt.load_model(fields["model_type"], sd, device="cpu")
    opt = tt.make_optimizer(tmodel, tcfg)
    schedule = tt.lr_schedule(tcfg, n_train)
    tmasks = prune.nonzero_masks(sd)
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y).long()
    tlosses = [float(tt.train_step(tmodel, opt, xt, yt, tcfg, tmasks, schedule)[0])
               for _ in range(3)]
    np.testing.assert_allclose(tlosses, jlosses, rtol=0, atol=1e-8)
    assert max_param_diff(p, tmodel.state_dict()) <= 1e-8
    if fields.get("finetune"):
        for name, m in tmasks.items():
            assert not torch.any(tmodel.state_dict()[name][~m])


@pytest.mark.parametrize("epochs,n_train,batch", [(1, 409, 128), (3, 26214, 1024), (5, 3276, 512),
                                                  (2, 7000, 100), (20, 1000, 64), (4, 12000, 96)])
def test_cosine_schedule_equal_optax(epochs, n_train, batch):
    cfg = tt.TrainConfig(lr_schedule="cosine", num_epochs=epochs, batch_size=batch)
    schedule = tt.lr_schedule(cfg, n_train)
    total = epochs * -(-n_train // batch)
    want = optax.warmup_cosine_decay_schedule(
        init_value=cfg.lr * 0.1, peak_value=cfg.lr, warmup_steps=max(1, total // 20),
        decay_steps=total, end_value=cfg.lr * 0.01)
    for k in range(total + 3):
        w = float(want(jnp.int32(k)))
        assert abs(schedule(k) - w) <= 1e-7 * w, (k, schedule(k), w)
    assert tt.lr_schedule(tt.TrainConfig(), n_train) is None


def test_shift_augment_bit_equal():
    rng = np.random.default_rng(3)
    imgs = rng.random((37, 28, 28), dtype=np.float32)
    for shape in ((37, 784), (37, 28, 28), (37, 28, 28, 1)):
        a, b = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(2):  # the rng advances identically
            got = tt.shift_augment(imgs.reshape(shape), a)
            want = jt.shift_augment(imgs.reshape(shape), b)
            assert got.shape == shape and got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,batch,seed", [(409, 128, 0), (512, 128, 3), (100, 128, 1), (1000, 7, 5)])
def test_batches_bit_equal(n, batch, seed):
    rng = np.random.default_rng(n)
    x = rng.random((n, 28, 28), dtype=np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    got = list(data.batches(x, y, batch, seed=seed))
    want = list(jdata.batches(x, y, batch, seed=seed))
    assert len(got) == len(want) == n // batch
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
    sets = data.batch_index_sets(n, batch, seed)
    assert sets.shape == (n // batch, batch)
    for idx, (gx, _) in zip(sets, got):
        np.testing.assert_array_equal(x[idx], gx)


TRAIN_CASES = {
    "MLP1": dict(model_type="MLP1"),
    "LeNet-l2reg": dict(model_type="LeNet", l2reg=True),
    "MLP1-cosine-augment": dict(model_type="MLP1", lr_schedule="cosine", augment=True),
}


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_train_one_epoch_equal_jax(case, mnist):
    fields = dict(TRAIN_CASES[case], num_epochs=1, batch_size=128)
    p = flax_init(fields["model_type"], mnist["train"][0])
    with jax.default_matmul_precision("float32"):
        want = jt.train(mnist, jt.TrainConfig(**fields), init_params=p, verbose=False)
    got = tt.train(mnist, tt.TrainConfig(**fields), init_params=as_state_dict(p), verbose=False,
                   device="cpu")
    assert sorted(got.history) == sorted(want.history)
    for k in want.history:
        np.testing.assert_allclose(got.history[k], want.history[k], rtol=0, atol=1e-4, err_msg=k)
    assert abs(got.best_val_acc - want.best_val_acc) <= 1e-4
    assert max_param_diff(want.params, got.params) <= 1e-4
    assert max_param_diff(want.best_params, got.best_params) <= 1e-4


def test_best_params_is_a_snapshot(mnist):
    # the best-validation params are a copy: later steps do not move them
    cfg = tt.TrainConfig(num_epochs=2, batch_size=128)
    res = tt.train(mnist, cfg, verbose=False, device="cpu")
    assert all(v.data_ptr() != res.params[k].data_ptr() for k, v in res.best_params.items())
    model = tt.load_model("MLP1", res.best_params, device="cpu")
    assert tt.evaluate(model, *mnist["val"], 128)[1] == res.best_val_acc


def test_evaluate_ragged_equal_jax(mnist):
    x, y = mnist["test"]  # 52 images: batches of 16 leave a tail of 4
    p = flax_init("LeNet", x)
    with jax.default_matmul_precision("float32"):
        want = jt.evaluate(p, jmake("LeNet").apply, x, y, 16)
    got = tt.evaluate(tt.load_model("LeNet", as_state_dict(p), device="cpu"), x, y, 16)
    assert abs(got[0] - want[0]) <= 1e-6
    assert got[1] == want[1]
    assert x.shape[0] % 16


@pytest.mark.parametrize("model_type,seeds", [("MLP1w", 1), ("MLP1", 4), ("LeNet", 40)])
def test_init_matches_flax_distribution(model_type, seeds):
    # lecun_normal: variance 1/fan_in, truncated at ±2 of the pre-correction
    # stddev; biases zero. Small layers pool several seeds per layer so
    # each std estimate rests on thousands of draws.
    draws = {}
    for seed in range(seeds):
        model = models.init_lecun_normal_(models.make_model(model_type), seed)
        for name, t in model.state_dict().items():
            if name.endswith("bias"):
                assert torch.count_nonzero(t) == 0
            else:
                draws.setdefault(name, []).append(t.numpy().ravel())
    flax = jax.tree_util.tree_leaves(flax_init("MLP1w" if model_type == "MLP1w" else model_type,
                                                np.zeros((2, 28, 28), np.float32)))
    flax_max = max(float(np.abs(np.asarray(a)).max() * np.sqrt(a.size / a.shape[-1]))
                   for a in flax if a.ndim > 1)
    for name, ds in draws.items():
        w = np.concatenate(ds)
        fan_in = models.make_model(model_type).state_dict()[name][0].numel()
        std = np.sqrt(1.0 / fan_in)
        assert abs(w.std() / std - 1) < 0.05, (name, w.std(), std)
        assert abs(w.mean()) < 0.05 * std, name
        bound = 2 * std / 0.87962566103423978
        assert np.abs(w).max() <= bound * (1 + 1e-6), name
        assert np.abs(w).max() > 0.95 * bound, name
    # flax's draws obey the same bound (in units of 1/sqrt(fan_in))
    assert flax_max <= 2 / 0.87962566103423978 * (1 + 1e-6)
    again = models.init_lecun_normal_(models.make_model(model_type), 0).state_dict()
    first = models.init_lecun_normal_(models.make_model(model_type), 0).state_dict()
    assert all(torch.equal(again[k], first[k]) for k in first)


def test_finetune_keeps_zeros(mnist):
    cfg = tt.TrainConfig(num_epochs=1, batch_size=128, l2reg=True)
    res = tt.train(mnist, cfg, verbose=False, device="cpu")
    pruned = prune.prune_params(res.params, sparsity_level=0.1)
    ft = tt.finetune(mnist, cfg, pruned, verbose=False, device="cpu")
    for out in (ft.params, ft.best_params):
        for name, w in pruned.items():
            if name.endswith("weight"):
                assert not torch.any((out[name] != 0) & (w == 0)), name
                assert torch.count_nonzero(out[name]) > 0


def test_save_params_read_by_jax(tmp_path, mnist):
    cfg = tt.TrainConfig(model_type="LeNet", num_epochs=1, batch_size=128)
    res = tt.train(mnist, cfg, verbose=False, device="cpu")
    path = str(tmp_path / "sub" / "lenet.pkl")
    tt.save_params(path, res.best_params)
    got = jt.load_params(path)
    want = params_from_state_dict(res.best_params)
    assert sorted(got) == sorted(want) == ["Conv_0", "Conv_1", "Dense_0", "Dense_1", "Dense_2"]
    for k in want:
        for n in ("kernel", "bias"):
            assert got[k][n].dtype == np.float32
            np.testing.assert_array_equal(got[k][n], want[k][n])
    # the JAX model runs the pickle; the port reads it back exactly
    jlogits, _ = jmake("LeNet").apply({"params": got}, jnp.asarray(mnist["test"][0][:4]))
    assert np.isfinite(np.asarray(jlogits)).all()
    assert flax_load(path).keys() == want.keys()
    back = tt.load_params(path)
    assert all(torch.equal(back[k], v) for k, v in res.best_params.items())


def test_checkpoint_resumes_to_the_same_next_step(tmp_path, mnist):
    cfg = tt.TrainConfig(num_epochs=2, batch_size=128, lr_schedule="cosine", l2reg=True)
    schedule = tt.lr_schedule(cfg, mnist["train"][0].shape[0])
    x, y = torch.from_numpy(mnist["train"][0]), torch.from_numpy(mnist["train"][1]).long()
    batches = [(x[i:i + 128], y[i:i + 128]) for i in (0, 128, 256)]

    def fresh():
        model = models.init_lecun_normal_(models.make_model("MLP1"), 0)
        return model, tt.make_optimizer(model, cfg)

    model, opt = fresh()
    for xb, yb in batches[:2]:
        tt.train_step(model, opt, xb, yb, cfg, schedule=schedule)
    path = str(tmp_path / "ckpt.pt")
    tt.save_checkpoint(path, model, opt)
    tt.train_step(model, opt, *batches[2], cfg, schedule=schedule)
    lr_before = opt.param_groups[0]["lr"]

    model2, opt2 = fresh()
    tt.load_checkpoint(path, model2, opt2)
    tt.train_step(model2, opt2, *batches[2], cfg, schedule=schedule)
    assert opt2.param_groups[0]["lr"] == lr_before == schedule(2)
    for k, v in model.state_dict().items():
        assert torch.equal(model2.state_dict()[k], v), k


def test_training_stats_and_plots(tmp_path):
    history = {"train_loss": [2.0, 1.5], "train_acc": [0.3, 0.6],
               "val_loss": [2.1, 1.6], "val_acc": [0.25, 0.55]}
    tt.save_training_stats(str(tmp_path / "port.stats"), history)
    jt.save_training_stats(str(tmp_path / "jax.stats"), history)
    with open(tmp_path / "port.stats", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.stats", "rb") as f:
        want = pickle.load(f)
    assert got == want and isinstance(got, tuple) and len(got) == 4
    paths = tt.plot_training_stats(str(tmp_path / "run"), history)
    assert [os.path.basename(p) for p in paths] == ["run_loss.png", "run_acc.png"]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_activation_sparsity_equal_jax(mnist):
    x = mnist["test"][0][:8]
    p = flax_init("LeNet", x)
    _, jacts = jmake("LeNet").apply({"params": p}, jnp.asarray(x))
    with torch.no_grad():
        _, acts = tt.load_model("LeNet", as_state_dict(p), device="cpu")(torch.from_numpy(x))
    # one ReLU output of 37,632 that lands on the other side of zero moves
    # conv1-out's fraction by 2.7e-5
    np.testing.assert_allclose(models.activation_sparsity(acts), j_activation_sparsity(jacts),
                               rtol=0, atol=1e-4)
