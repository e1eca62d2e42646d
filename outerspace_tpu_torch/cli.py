"""The port's command line.

    python -m outerspace_tpu_torch.cli spgemm M1.mtx M2.mtx [--strategy ...] [--out C.mtx]
        [--mesh KX[,NY] [--chunks N] [--merge-parts N] [--dist-backend {nccl,gloo}]]
    python -m outerspace_tpu_torch.cli graph {triangles,mcl} G.mtx [--iters N]
        [--mesh KX[,NY] [--loop {host,device}] [--dist-backend {nccl,gloo}]]
    python -m outerspace_tpu_torch.cli nn --mode {train,prune,finetune,eval,pf,export} ...
    python -m outerspace_tpu_torch.cli predict M1.mtx M2.mtx [--no-transpose] [--mesh KX[,NY]]
    python -m outerspace_tpu_torch.cli bench [--only NAME[,NAME...]] [--small]

``spgemm`` reads two Matrix Market files and computes C = M1 · M2ᵀ
(``--no-transpose``: M1 · M2), then prints C's shape and nnz, the
multiply-phase FLOP count, the card's roofline for the multiply and the
merge (``perf.roofline``), the event model's multiply and merge
(``perf.perfsim``), the measured end-to-end time of a warm call and
GFLOP/s; ``--out`` writes C. ``graph`` counts triangles or runs
Markov clustering (MCL, with the roofline of its chain) on one graph.
``spgemm --mesh KX[,NY]`` and ``graph triangles --mesh KX[,NY]`` run the
sharded mode: the host plans, then a world of kx·ny ranks
(``shard.mesh.run_world``) runs the tiled sharded program, its product
gathered to rank 0 (``--dist-backend``: ``nccl``, one rank per card, the
default with ``--device cuda``; ``gloo``, the default with ``--device
cpu``, which also lets the ranks share one card). ``graph mcl --mesh``
runs the sharded Markov clustering in such a world: ``--loop host``
(the default) plans every squaring on the host
(``ops.graph.markov_cluster_sharded``), ``--loop device`` keeps the
whole loop on the ranks' devices (``shard.mcl``).
``predict`` plans C = M1 · M2ᵀ for a mesh (any size; no card, nothing
launched) and prints the FLOP count, the sharded plan's sizes, the
roofline (``perf.roofline.predict_sharded_tiled``) and the event model
(``perf.perfsim.simulate_sharded_tiled``) of the sharded program; the
sharded ``spgemm`` prints both beside its measured time. A failure in the
event model fails the command.
``nn`` is the NN pipeline: train a model, magnitude-prune it, finetune
the pruned model with its zeros kept, evaluate it on the test split,
``pf`` (train, prune, finetune with evaluations in between) and
``export`` (the weights and one test batch's activations as ``.mtx``
SpGEMM operands); ``--data mnist`` without idx files
(``nn.data.find_mnist_dir``) trains on ``synthetic_mnist`` instead.
``bench`` runs the benchmark suite (``outerspace_tpu_torch.bench``): one
JSON record per workload on the standard error, the headline line on the
standard output, exit 1 if a record failed or is not exact.

The arguments and defaults are the JAX package's ``cli.py``; ``--device``
(default ``cuda``) picks where the work runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import sys
import time

from outerspace_tpu_torch import bench

SHARDED_REPS = 3  # timed runs of spgemm --mesh after its first run

def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _mesh_dims(mesh) -> tuple[int, int] | None:
    """(kx, ny) of a ``KX[,NY]`` mesh flag; prints why and returns None if
    it is not one."""
    try:
        dims = [int(x) for x in str(mesh).split(",")]
    except ValueError:
        dims = []
    if not 1 <= len(dims) <= 2 or any(d < 1 for d in dims):
        print(f"bad --mesh {mesh!r}: expected KX or KX,NY "
              "(positive integers, e.g. --mesh 4,2)", file=sys.stderr)
        return None
    return dims[0], (dims[1] if len(dims) > 1 else 1)


def _parse_mesh(args) -> tuple[int, int, str] | None:
    """(kx, ny, backend) of a ``KX[,NY]`` mesh flag, checked against the
    backend and the cards; prints why and returns None on any problem
    (shared by ``spgemm --mesh`` and ``graph --mesh``)."""
    import torch

    dims = _mesh_dims(args.mesh)
    if dims is None:
        return None
    kx, ny = dims
    on_card = torch.device(args.device).type == "cuda"
    backend = args.dist_backend or ("nccl" if on_card else "gloo")
    if backend == "nccl":
        cards = torch.cuda.device_count() if on_card else 0
        if not on_card:
            print("--dist-backend nccl runs on CUDA devices; --device cpu uses gloo",
                  file=sys.stderr)
            return None
        if kx * ny > cards:
            print(f"mesh {kx}x{ny} needs {kx * ny} cards for nccl (one rank per card), "
                  f"{cards} found (--dist-backend gloo runs the ranks on the cards "
                  "there are, sharing them)", file=sys.stderr)
            return None
    elif on_card and not torch.cuda.is_available():
        print("--device cuda needs a CUDA device", file=sys.stderr)
        return None
    return kx, ny, backend


def _build_for_ranks(device) -> None:
    """Build the kernels and the planner core before the ranks start, so
    that they do not each build them."""
    import torch

    from outerspace_tpu_torch.runtime import build

    build.build_host("gplan")
    if torch.device(device).type == "cuda":
        build.build()


def _summed_launches(results) -> str:
    """The ranks' kernel launches, summed, as "K1 n, K2 n, ..."."""
    names = results[0]["launches"]
    return ", ".join(f"{k} {sum(r['launches'][k] for r in results)}" for k in names)


def _event_model_sharded(plan) -> str:
    """The event model's line for a sharded plan."""
    from outerspace_tpu_torch.perf.perfsim import simulate_sharded_tiled

    ev = simulate_sharded_tiled(plan)
    exch = ev["exchange_done_cycles"] - ev["expand_sort_cycles"]
    return (f"event-model sharded:            {ev['seconds'] * 1e3:.3f} ms "
            f"(front {ev['expand_sort_cycles']} cyc, exchange {max(exch, 0)} cyc, "
            f"max link busy {ev['max_link_busy']} cyc)")


def _cmd_spgemm_sharded(args, a_csc, b_csr, mesh) -> int:
    """``spgemm --mesh KX[,NY]``: plan on the host, then a world of kx·ny
    ranks runs the tiled sharded program (a first run, then
    ``SHARDED_REPS`` timed ones) and gathers the product to rank 0."""
    from outerspace_tpu_torch.formats import write_mtx
    from outerspace_tpu_torch.formats.csr import CSR
    from outerspace_tpu_torch.ops.reference import spgemm_flops
    from outerspace_tpu_torch.perf.roofline import predict_sharded_tiled
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.tiled import shard_plan_tiled
    from outerspace_tpu_torch.shard.world import run_jobs

    kx, ny, backend = mesh
    flops = spgemm_flops(a_csc, b_csr)
    t0 = time.perf_counter()
    plan = shard_plan_tiled(a_csc, b_csr, kx=kx, ny=ny,
                            exchange_chunks=max(int(args.chunks or 1), 1),
                            merge_parts=args.merge_parts)
    t_plan = time.perf_counter() - t0
    _build_for_ranks(args.device)
    job = dict(program="tiled", mesh=(kx, ny) if ny > 1 else (kx,), plan=plan, csr=True,
               entries=False, reps=SHARDED_REPS)
    ranks = run_world(run_jobs, kx * ny, backend=backend, device=args.device, args=([job],))
    res = [r[0] for r in ranks]
    shape, indptr, indices, data = res[0]["csr"]
    c = CSR(shape, indptr, indices, data)
    elapsed = max(r["median_s"] for r in res)  # the slowest rank
    print(f"C shape: {c.shape}, nnz: {c.nnz}")
    print(f"multiply flops: {flops}")
    print(f"mesh: {kx}x{ny} over {kx * ny} ranks ({res[0]['mesh']}); plan {t_plan:.2f}s; "
          f"{plan.chunks} chunk(s), {plan.merge_parts} merge part(s)"
          f"{', rebased keys' if plan.rebase else ''}")
    print(f"analytical sharded (roofline):  {predict_sharded_tiled(plan) * 1e3:.3f} ms")
    print(_event_model_sharded(plan))
    print(f"measured (sharded, warm, median of {SHARDED_REPS}): {elapsed * 1e3:.3f} ms "
          f"({flops / max(elapsed, 1e-12) / 1e9:.3f} GFLOP/s)")
    print(f"kernel launches (all ranks, first run): {_summed_launches(res)}")
    if args.out:
        write_mtx(args.out, c)
        print(f"wrote {args.out}")
    return 0


def cmd_spgemm(args) -> int:
    from outerspace_tpu_torch.config import DEFAULT
    from outerspace_tpu_torch.formats import read_mtx, write_mtx
    from outerspace_tpu_torch.ops.reference import spgemm_flops
    from outerspace_tpu_torch.ops.spgemm import default_part_count, spgemm
    from outerspace_tpu_torch.ops.symbolic import expansion_plan
    from outerspace_tpu_torch.perf import perfsim
    from outerspace_tpu_torch.perf.roofline import predict_merge_time, predict_multiply_time
    from outerspace_tpu_torch.sched.autotune import autotune
    from outerspace_tpu_torch.sched.gplanner import perf_part_count
    from outerspace_tpu_torch.sched.planner import plan_outer_classes

    mesh = None
    if args.mesh:
        mesh = _parse_mesh(args)
        if mesh is None:
            return 2
    cfg = DEFAULT.override(args.set or [])
    m1 = read_mtx(args.matrix1)
    m2 = read_mtx(args.matrix2)
    if not args.no_transpose:
        m2 = m2.transpose()
    a_csc, b_csr = m1.to_csc(), m2.to_csr()
    if a_csc.shape[1] != b_csr.shape[0]:
        print(f"dimension mismatch: {a_csc.shape} @ {b_csr.shape}", file=sys.stderr)
        return 2
    if mesh is not None:
        return _cmd_spgemm_sharded(args, a_csc, b_csr, mesh)
    flops = spgemm_flops(a_csc, b_csr)
    plan = expansion_plan(a_csc, b_csr)
    p_pad = plan.padded_size()
    # one cost-model pick for the strategy, its waste limit and the merge
    # parts the picked pipeline sorts in
    strategy, waste_limit = autotune(a_csc, b_csr)
    if args.strategy != "auto":
        strategy = args.strategy
    if cfg.waste_limit is None:
        cfg = dataclasses.replace(cfg, waste_limit=waste_limit)
    merge_parts = {"gather": perf_part_count(plan.expansion_size),
                   "tiles": default_part_count(p_pad), "flat": 1}[strategy]
    roof_mult = predict_multiply_time(p_pad, m1.nnz, m2.nnz)
    roof_merge = predict_merge_time(p_pad, parts=merge_parts)
    spgemm(a_csc, b_csr, strategy=strategy, config=cfg, device=args.device)  # warm
    t0 = time.perf_counter()
    c = spgemm(a_csc, b_csr, strategy=strategy, config=cfg, device=args.device)
    _sync(args.device)
    elapsed = time.perf_counter() - t0
    print(f"C shape: {c.shape}, nnz: {c.nnz}")
    print(f"multiply flops: {flops}")
    print(f"strategy: {strategy} (waste limit {cfg.waste_limit}, merge parts {merge_parts})")
    print(f"analytical multiply (roofline): {roof_mult * 1e3:.3f} ms")
    print(f"analytical merge (roofline):    {roof_merge * 1e3:.3f} ms")
    # the event model over the class tables: each class's task stream (B
    # major) through an on-chip cache of the B blocks K3 holds at once
    # (perfsim's defaults, read from csrc/expand.cu: one 1 KiB B block a
    # line, kUnroll = 2 a block, 4 blocks an SM, 132 SMs)
    classes = plan_outer_classes(a_csc, b_csr, waste_limit=cfg.waste_limit).classes
    mult_s = hits = misses = 0
    for cl in classes:
        if cl.ntasks:
            pred = perfsim.simulate_expand_cached(cl)
            mult_s += pred["seconds"]
            hits += pred["hits"]
            misses += pred["misses"]
    print(f"event-model multiply:           {mult_s * 1e3:.3f} ms "
          f"(on-chip B-group hit rate {hits / max(hits + misses, 1):.0%})")
    # the merge: the picked pipeline's parts, each an even share of the
    # padded stream, written back as the measured nnz's share
    base, rem = divmod(p_pad, merge_parts)
    part_lens = [base + (1 if i < rem else 0) for i in range(merge_parts)]
    mpred = perfsim.simulate_merge_parts(part_lens, [8 * (c.nnz // merge_parts + 1)] * merge_parts)
    print(f"event-model merge:              {mpred['seconds'] * 1e3:.3f} ms "
          f"(parts={merge_parts}, sort util {mpred['sort_util']:.0%})")
    print(f"measured (end-to-end): {elapsed * 1e3:.3f} ms")
    print(f"GFlops: {flops / elapsed / 1e9:.4f}")
    if args.out:
        write_mtx(args.out, c)
        print(f"wrote {args.out}")
    return 0


def cmd_graph(args) -> int:
    from outerspace_tpu_torch.formats import read_mtx
    from outerspace_tpu_torch.ops.graph import markov_cluster, mcl_clusters, triangle_count
    from outerspace_tpu_torch.perf.roofline import predict_mcl_time

    mesh = None
    if args.mesh:
        # the sharded program cannot honour a backend or route override
        if args.backend != "torch" or args.strategy != "auto":
            print("error: --mesh runs the sharded device path; it cannot be combined "
                  "with --backend/--strategy overrides", file=sys.stderr)
            return 2
        mesh = _parse_mesh(args)
        if mesh is None:
            return 2
    g = read_mtx(args.matrix)
    if mesh is not None:
        from outerspace_tpu_torch.shard.mesh import run_world
        from outerspace_tpu_torch.shard.world import run_jobs

        kx, ny, backend = mesh
        _build_for_ranks(args.device)
        job = dict(program=args.kernel, mesh=(kx, ny) if ny > 1 else (kx,), adj=g)
        if args.kernel == "mcl":
            job.update(loop=args.loop, iters=args.iters)
        res = [r[0] for r in run_world(run_jobs, kx * ny, backend=backend, device=args.device,
                                       args=([job],))]
        dt = max(r["seconds"][0] for r in res)
        if args.kernel == "triangles":
            print(f"triangles (mesh {kx}x{ny}, {backend}): {res[0]['count']} ({dt * 1e3:.1f} ms)")
        else:
            from outerspace_tpu_torch.formats.csr import CSR

            clusters = mcl_clusters(CSR(*res[0]["csr"]))
            print(f"mcl (mesh {kx}x{ny}, {args.loop} loop): {len(clusters)} clusters "
                  f"({dt * 1e3:.1f} ms)")
            report = res[0]["report"]
            print(f"mcl sharded ({backend}): {report['iterations']} iteration(s), converged "
                  f"{report['converged']}"
                  + (f", fast path {report['fast_path']}, host reads {report['host_reads']}"
                     if args.loop == "device" else ""))
        print(f"kernel launches (all ranks): {_summed_launches(res)}")
        return 0
    if args.kernel == "triangles":
        t0 = time.perf_counter()
        n = triangle_count(g, strategy=args.strategy, backend=args.backend, device=args.device)
        dt = time.perf_counter() - t0
        print(f"triangles: {n} ({dt * 1e3:.1f} ms)")
        return 0
    report: dict = {}
    t0 = time.perf_counter()
    flow = markov_cluster(g, iters=args.iters, backend=args.backend, device=args.device,
                          report=report)
    clusters = mcl_clusters(flow)
    dt = time.perf_counter() - t0
    if report.get("p_pad"):
        pred = predict_mcl_time(
            report["stage1_stream"],
            report.get("p_pads") or (report["p_pad"],) * max(report["iters"] - 1, 0),
            report.get("elem_pad") or report["nnz_pad"],
            stage1_parts=report["stage1_parts"],
        )
        print(f"analytical model: {pred * 1e3:.1f} ms")
    elif report.get("fast_path") is False:
        # the exact stepwise chain ran, which the chain's model does not describe
        print("analytical model: n/a (stepwise fallback ran)")
    print(f"mcl: {len(clusters)} clusters ({dt * 1e3:.1f} ms)")
    return 0


def cmd_predict(args) -> int:
    """``predict M1.mtx M2.mtx --mesh KX[,NY]``: both models of C = M1 · M2ᵀ
    over a mesh, with no device work: the sharded plan's roofline
    (``roofline.predict_sharded_tiled``) and the event model
    (``perfsim.simulate_sharded_tiled``). Any mesh size may be modelled;
    no card is needed."""
    from outerspace_tpu_torch.formats import read_mtx
    from outerspace_tpu_torch.ops.reference import spgemm_flops
    from outerspace_tpu_torch.perf.roofline import predict_sharded_tiled
    from outerspace_tpu_torch.shard.tiled import shard_plan_tiled

    dims = _mesh_dims(args.mesh)
    if dims is None:
        return 2
    kx, ny = dims
    m1 = read_mtx(args.matrix1)
    m2 = read_mtx(args.matrix2)
    if not args.no_transpose:
        m2 = m2.transpose()
    a_csc, b_csr = m1.to_csc(), m2.to_csr()
    if a_csc.shape[1] != b_csr.shape[0]:
        print(f"dimension mismatch: {a_csc.shape} @ {b_csr.shape}", file=sys.stderr)
        return 2
    plan = shard_plan_tiled(a_csc, b_csr, kx=kx, ny=ny)
    print(f"multiply flops: {spgemm_flops(a_csc, b_csr)}")
    mode = "rebased per-bucket keys" if plan.rebase else "global keys"
    print(f"mesh {kx}x{ny} ({mode}): per-device stream {plan.stream_len}, "
          f"exchange capacity {plan.capacity} x{plan.chunks} chunk(s), "
          f"merge {plan.merge_parts} part(s) x {plan.kx * plan.mcap}")
    print(f"analytical sharded (roofline):  {predict_sharded_tiled(plan) * 1e3:.3f} ms")
    print(_event_model_sharded(plan))
    return 0


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


def _mesh_arguments(p) -> None:
    p.add_argument("--mesh", default=None, metavar="KX[,NY]",
                   help="run the sharded program over a KX x NY mesh of ranks")
    p.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                   dest="dist_backend",
                   help="the ranks' torch.distributed backend (default: nccl with "
                        "--device cuda, one rank per card; gloo with --device cpu; gloo "
                        "with --device cuda shares the cards among the ranks)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="outerspace_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("spgemm", help="C = M1 · M2ᵀ from .mtx operands")
    p.add_argument("matrix1")
    p.add_argument("matrix2")
    p.add_argument("--strategy", default="auto", choices=["auto", "flat", "tiles", "gather"])
    p.add_argument("--no-transpose", action="store_true",
                   help="compute M1 · M2 instead of M1 · M2ᵀ")
    p.add_argument("--out", default=None, help="write result .mtx here")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="override a Config field (e.g. --set waste_limit=3.0)")
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs there)")
    _mesh_arguments(p)
    p.add_argument("--chunks", type=int, default=1,
                   help="sharded exchange chunks: each owner's rows exchanged and merged "
                        "in this many parts")
    p.add_argument("--merge-parts", type=int, default=None, dest="merge_parts",
                   help="key-range parts per sharded chunk merge (default: auto, ~2M "
                        "pairs a part; 1 on a one-rank k axis, whose merge skips its sort)")
    p.set_defaults(fn=cmd_spgemm)

    p = sub.add_parser("nn", help="NN pipeline (train/prune/finetune/eval/pf/export)")
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

    p = sub.add_parser("graph", help="graph kernels via repeated A²")
    p.add_argument("kernel", choices=["triangles", "mcl"])
    p.add_argument("matrix")
    p.add_argument("--backend", default="torch", choices=["torch", "scipy"])
    p.add_argument("--strategy", default="auto", choices=["auto", "dense", "sparse"],
                   help="triangles only: dense product vs the sparse pipeline "
                        "(auto = the selector's pick)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--device", default="cuda", help="torch device (default cuda; cpu runs there)")
    _mesh_arguments(p)
    p.add_argument("--loop", default="host", choices=["host", "device"],
                   help="mcl --mesh only: 'device' keeps the whole loop on the ranks' devices "
                        "(shard/mcl.py, no host planning between iterations); 'host' plans "
                        "each squaring on the host")
    p.set_defaults(fn=cmd_graph)

    p = sub.add_parser("predict", help="roofline and event model of the sharded "
                       "C = M1 · M2ᵀ (host only, no card needed)")
    p.add_argument("matrix1")
    p.add_argument("matrix2")
    p.add_argument("--no-transpose", action="store_true",
                   help="predict M1 · M2 instead of M1 · M2ᵀ")
    p.add_argument("--mesh", default="1", metavar="KX[,NY]",
                   help="the mesh to model, e.g. 4 or 4,2 (any size)")
    p.set_defaults(fn=cmd_predict)

    p = sub.add_parser("bench", help="the benchmark suite (one JSON headline line)")
    bench.add_arguments(p)
    p.set_defaults(fn=bench.run_args)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
