"""``python -m outerspace_tpu_torch.cli nn``: every mode runs on the CPU
(``--device cpu --data synthetic``), writes what the JAX CLI writes, and
``pf``'s pickle serves through ``SparseMLP(device="cpu")`` within 1e-5
of the dense model, relative to the largest logit."""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from outerspace_tpu_torch import cli
from outerspace_tpu_torch.convert import load_params
from outerspace_tpu_torch.nn.data import synthetic_mnist
from outerspace_tpu_torch.nn.sparse_infer import SparseLeNet, SparseMLP, mlp_forward_dense

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--data", "synthetic", "--num_epochs", "1"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    path = str(d / "mlp1.pkl")
    assert cli.main(["nn", "--mode", "train", *CPU, "--saved_model_name", path]) == 0
    return d, path


def test_train_writes_params_stats_and_plots(trained, capsys):
    d, path = trained
    params = load_params(path)
    assert sorted(params) == ["Dense_0", "Dense_1", "Dense_2"]
    assert params["Dense_0"]["kernel"].shape == (784, 100)
    with open(path + ".stats", "rb") as f:
        stats = pickle.load(f)
    assert isinstance(stats, tuple) and len(stats) == 4 and len(stats[0]) == 1
    assert os.path.exists(path + "_loss.png") and os.path.exists(path + "_acc.png")


@pytest.mark.parametrize("mode", ["eval", "prune", "finetune", "export"])
def test_modes_from_a_saved_model(trained, mode, capsys):
    d, path = trained
    out = str(d / f"{mode}.pkl")
    args = ["nn", "--mode", mode, *CPU, "--load_model_name", path, "--saved_model_name", out,
            "--save_dir", str(d / "mtx")]
    assert cli.main(args) == 0
    text = capsys.readouterr().out
    if mode == "eval":
        assert "eval: test_loss=" in text
    elif mode == "prune":
        assert "dense.0.weight: nnz=7840/78400" in text and "pruned: test_loss=" in text
        pruned = load_params(out)
        for layer in ("Dense_0", "Dense_1", "Dense_2"):
            k = pruned[layer]["kernel"]
            assert np.count_nonzero(k) == round(0.1 * k.size)
    elif mode == "finetune":
        assert "finetuned: test_loss=" in text and os.path.exists(out)
    else:
        names = sorted(os.listdir(d / "mtx"))
        assert names == ["act_0.mtx", "act_1.mtx", "act_2.mtx", "fc1_weight.mtx",
                         "fc2_weight.mtx", "fc3_weight.mtx", "logits.mtx"]


def test_pf_pickle_serves_through_sparse_mlp(tmp_path, capsys):
    path = str(tmp_path / "pf.pkl")
    assert cli.main(["nn", "--mode", "pf", *CPU, "--saved_model_name", path]) == 0
    text = capsys.readouterr().out
    for tag in ("trained:", "pruned:", "finetuned:"):
        assert tag in text
    params = load_params(path)
    for layer in params.values():
        k = layer["kernel"]
        assert np.count_nonzero(k) <= round(0.1 * k.size)
    x = synthetic_mnist(80, seed=0)["test"][0]
    y = SparseMLP(params, device="cpu")(x).numpy()
    ref = mlp_forward_dense(params, x)
    assert np.abs(y - ref).max() <= 1e-5 * np.abs(ref).max()


def test_lenet_pf_serves_through_sparse_lenet(tmp_path, capsys):
    path = str(tmp_path / "lenet.pkl")
    args = ["nn", "--mode", "pf", *CPU, "--model_type", "LeNet", "--l2reg",
            "--lr_schedule", "cosine", "--saved_model_name", path]
    assert cli.main(args) == 0
    params = load_params(path)
    assert sorted(params) == ["Conv_0", "Conv_1", "Dense_0", "Dense_1", "Dense_2"]
    x = synthetic_mnist(80, seed=0)["test"][0][..., None]
    from outerspace_tpu_torch.convert import state_dict_from_params
    from outerspace_tpu_torch.nn.models import make_model

    dense = make_model("LeNet")
    dense.load_state_dict(state_dict_from_params(params))
    with torch.no_grad():
        ref = dense(torch.from_numpy(x))[0]
    y = SparseLeNet(params, device="cpu")(x)
    assert float((y - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_missing_model_and_help(capsys):
    assert cli.main(["nn", "--mode", "eval", *CPU]) == 2
    assert "--load_model_name" in capsys.readouterr().err
    out = subprocess.run([sys.executable, "-m", "outerspace_tpu_torch.cli", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0
    assert "Not ported yet" in out.stdout and "bench" in out.stdout
    # bench is not ported: exit 2 with the message; predict and spgemm
    # read their files
    assert cli.main(["bench"]) == 2
    assert cli.NOT_PORTED in capsys.readouterr().err
    with pytest.raises(FileNotFoundError):
        cli.main(["predict", "a.mtx", "b.mtx"])
    with pytest.raises(FileNotFoundError):
        cli.main(["spgemm", "a.mtx", "b.mtx", "--device", "cpu"])
    with pytest.raises(SystemExit):
        cli.main(["sharded"])
