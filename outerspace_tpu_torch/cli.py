"""The port's command line.

    python -m outerspace_tpu_torch.cli nn --mode {train,prune,finetune,eval,pf,export} ...

``nn`` is the NN pipeline: train a model, magnitude-prune it, finetune
the pruned model with its zeros kept, evaluate it on the test split,
``pf`` (train, prune, finetune with evaluations in between) and
``export`` (the weights and one test batch's activations as ``.mtx``
SpGEMM operands). The arguments and defaults are the JAX package's
``cli.py nn``; ``--device`` (default ``cuda``) picks where it runs.
``--data mnist`` without idx files (``nn.data.find_mnist_dir``) trains on
``synthetic_mnist`` instead.
"""

from __future__ import annotations

import argparse
import importlib.util
import sys

NOT_PORTED = (
    "Not ported yet: the spgemm and graph subcommands, predict, and --mesh "
    "(the sharded mode)."
)


def cmd_nn(args) -> int:
    from outerspace_tpu_torch.nn.data import find_mnist_dir, load_mnist, synthetic_mnist
    from outerspace_tpu_torch.nn.prune import prune_params, sparsity_report
    from outerspace_tpu_torch.nn.train import (
        TrainConfig,
        evaluate,
        finetune,
        load_model,
        load_params,
        plot_training_stats,
        save_params,
        save_training_stats,
        train,
    )

    data = (
        load_mnist()
        if (args.data == "mnist" and find_mnist_dir())
        else synthetic_mnist(n=4096)
    )
    cfg = TrainConfig(
        model_type=args.model_type,
        num_epochs=args.num_epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        lr_schedule=args.lr_schedule,
        augment=args.augment,
        l2reg=args.l2reg,
    )
    params = load_params(args.load_model_name) if args.load_model_name else None
    if args.mode in ("eval", "prune", "finetune", "export") and params is None:
        print(f"--mode {args.mode} needs --load_model_name", file=sys.stderr)
        return 2

    def report_eval(p, tag):
        model = load_model(args.model_type, p, device=args.device)
        loss, acc = evaluate(model, *data["test"], cfg.batch_size)
        print(f"{tag}: test_loss={loss:.4f} test_acc={acc:.4f}")

    if args.mode == "train":
        res = train(data, cfg, init_params=params, device=args.device)
        report_eval(res.best_params, "trained")
        if args.saved_model_name:
            save_params(args.saved_model_name, res.best_params)
            save_training_stats(args.saved_model_name + ".stats", res.history)
            if importlib.util.find_spec("matplotlib") is None:
                print("  matplotlib is not installed: no plots")
            else:
                for p in plot_training_stats(args.saved_model_name, res.history):
                    print(f"  wrote {p}")
    elif args.mode == "eval":
        report_eval(params, "eval")
    elif args.mode == "prune":
        pruned = prune_params(params, args.sparsity_level)
        for name, (nnz, numel, frac) in sparsity_report(pruned).items():
            print(f"  {name}: nnz={nnz}/{numel} ({frac:.4f})")
        report_eval(pruned, "pruned")
        if args.saved_model_name:
            save_params(args.saved_model_name, pruned)
    elif args.mode == "finetune":
        res = finetune(data, cfg, params, device=args.device)
        report_eval(res.best_params, "finetuned")
        if args.saved_model_name:
            save_params(args.saved_model_name, res.best_params)
    elif args.mode == "pf":
        res = train(data, cfg, init_params=params, device=args.device)
        report_eval(res.best_params, "trained")
        pruned = prune_params(res.best_params, args.sparsity_level)
        report_eval(pruned, "pruned")
        ft = finetune(data, cfg, pruned, device=args.device)
        report_eval(ft.best_params, "finetuned")
        if args.saved_model_name:
            save_params(args.saved_model_name, ft.best_params)
    else:  # export
        from outerspace_tpu_torch.nn.export import export_lenet, export_mlp1

        x = data["test"][0][: args.batch_size]
        exporter = export_lenet if args.model_type == "LeNet" else export_mlp1
        files = exporter(params, x, args.save_dir, device=args.device)
        for k, v in files.items():
            print(f"  {k}: {v}")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="outerspace_tpu_torch", epilog=NOT_PORTED)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("nn", help="NN pipeline (train/prune/finetune/eval/pf/export)",
                       epilog=NOT_PORTED)
    p.add_argument("--mode", required=True,
                   choices=["train", "prune", "finetune", "eval", "pf", "export"])
    p.add_argument("--model_type", default="MLP1", choices=["MLP1", "MLP1w", "LeNet"])
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--batch_size", type=int, default=512)
    p.add_argument("--sparsity_level", type=float, default=0.1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--lr_schedule", default="const", choices=["const", "cosine"])
    p.add_argument("--augment", action="store_true",
                   help="random +-2px shift augmentation (small-split aid)")
    p.add_argument("--l2reg", action="store_true")
    p.add_argument("--load_model_name", default=None)
    p.add_argument("--saved_model_name", default=None)
    p.add_argument("--save_dir", default="mtx_out")
    p.add_argument("--data", default="mnist", choices=["mnist", "synthetic"],
                   help="mnist falls back to synthetic_mnist when no idx files are found")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs there)")
    p.set_defaults(fn=cmd_nn)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
