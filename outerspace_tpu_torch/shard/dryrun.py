"""The multi-device dry run: every sharded path of the port in one world
of n ranks, each result held to its oracle, and one line of their
numbers. The counterpart of the JAX package's
``__graft_entry__.dryrun_multichip`` (on the same operands and seeds):

- the MLP1 training step on a (dp, tp) mesh (``shard.train``), tp = 2
  where n is even, its loss held to the single-rank step from the same
  parameters (the port's own initialisation, seed 0: the flax one needs
  JAX), batch max(8·dp, 8) of ones, labels 0, L2 on;
- ``erdos_renyi(128, 128, 0.05, seed=7)`` A² by the 1-D and the 2-D
  (n/2 × 2 where n ≥ 4) flat programs; ``rmat(7, edge_factor=8,
  seed=9)`` A² by the tiled program in 1-D and in 2-D with 2 exchange
  chunks; the rebased 2³²-key corner; each exact against scipy;
- triangles of ``erdos_renyi(60, 60, 0.12, seed=6)`` and MCL (3
  iterations, both loops) of ``erdos_renyi(24, 24, 0.15, seed=4)``,
  exact against scipy;
- ``SparseMLP.sharded`` over n ranks on 2·n rows, bit-identical to the
  single-device forward (MLP1 from seed 1, pruned to 10%).

    python -m outerspace_tpu_torch.shard.dryrun 8 [--backend gloo] [--device cuda]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def dryrun_multichip(n: int, backend: str = "gloo", device: str = "cuda",
                     timeout: float = 600.0) -> str:
    """Run the dry run in a world of ``n`` ranks (``shard.mesh.run_world``
    with ``backend`` on ``device``); raise on any disagreement; print and
    return the line of numbers."""
    from outerspace_tpu_torch.shard.mesh import run_world
    from outerspace_tpu_torch.shard.world import run_jobs

    jobs, finish = dryrun_jobs(n, device)
    ranks = run_world(run_jobs, n, backend=backend, device=device, args=(jobs,),
                      timeout=timeout)
    line = finish(list(zip(*ranks)))
    print(line)
    return line


def dryrun_jobs(n: int, device: str = "cuda"):
    """The dry run as ``shard.world.run_jobs`` jobs for a world of ``n``
    ranks, and ``finish``: given each job's results (every rank's, in job
    order), it holds them to their oracles (the single-rank references
    on ``device``), raises on any disagreement, and returns the line."""
    import torch

    from outerspace_tpu_torch.convert import params_from_state_dict
    from outerspace_tpu_torch.formats import COO, CSR, erdos_renyi, rmat
    from outerspace_tpu_torch.nn import train
    from outerspace_tpu_torch.nn.models import MLP1, init_lecun_normal_
    from outerspace_tpu_torch.nn.prune import prune_params
    from outerspace_tpu_torch.nn.sparse_infer import SparseMLP
    from outerspace_tpu_torch.ops.graph import markov_cluster, mcl_clusters, triangle_count
    from outerspace_tpu_torch.ops.reference import assert_csr_allclose, spgemm_scipy
    from outerspace_tpu_torch.shard.spgemm_sharded import shard_plan, shard_plan_2d
    from outerspace_tpu_torch.shard.tiled import shard_plan_tiled
    from outerspace_tpu_torch.shard.train import tp_shape

    dp, tp = tp_shape(n)
    kx, ny = (n // 2, 2) if n >= 4 else (n, 1)
    g = erdos_renyi(128, 128, 0.05, seed=7)
    gt = rmat(7, edge_factor=8, seed=9).deduplicated()
    m16 = 1 << 16
    gr = COO((m16, m16), np.array([0, 0, 1, m16 - 1, m16 - 1, 7]),
             np.array([1, m16 - 1, 0, m16 - 1, 0, 7]), np.arange(1, 7, dtype=np.float32))
    gtri = erdos_renyi(60, 60, 0.12, seed=6)
    gmcl = erdos_renyi(24, 24, 0.15, seed=4)
    plan_r = shard_plan_tiled(gr.to_csc(), gr.to_csr(), kx=n)
    if not plan_r.rebase:
        raise RuntimeError("m*n = 2^32 must plan rebased keys")
    products = [  # (label, job, operand)
        ("sharded", dict(program="sharded", mesh=(n,), plan=shard_plan(g.to_csc(), g.to_csr(), n)),
         g),
        ("2-D", dict(program="sharded_2d", mesh=(kx, ny),
                     plan=shard_plan_2d(g.to_csc(), g.to_csr(), kx, ny)), g),
        ("tiled 1-D", dict(program="tiled", mesh=(n,),
                           plan=shard_plan_tiled(gt.to_csc(), gt.to_csr(), kx=n)), gt),
        ("tiled 2-D", dict(program="tiled", mesh=(kx, ny),
                           plan=shard_plan_tiled(gt.to_csc(), gt.to_csr(), kx=kx, ny=ny,
                                                 exchange_chunks=2)), gt),
        ("rebased", dict(program="tiled", mesh=(n,), plan=plan_r), gr),
    ]
    jobs = [dict(job, csr=True, entries=False) for _, job, _ in products]
    jobs.append(dict(program="triangles", mesh=(n,), adj=gtri))
    jobs += [dict(program="mcl", loop=loop, mesh=(n,), adj=gmcl, iters=3)
             for loop in ("host", "device")]
    # the train step, and sparse serving
    cfg = train.TrainConfig(batch_size=max(8 * dp, 8), l2reg=True)
    sd = init_lecun_normal_(MLP1(), seed=0).state_dict()
    x = np.ones((cfg.batch_size, 784), np.float32)
    y = np.zeros(cfg.batch_size, np.int64)
    jobs.append(dict(program="train", mesh=(dp, tp), state_dict=sd, x=x, y=y, cfg=cfg, steps=1))
    sp_params = params_from_state_dict(prune_params(init_lecun_normal_(MLP1(), seed=1)
                                                    .state_dict(), sparsity_level=0.1))
    xs = np.random.default_rng(0).random((2 * n, 784)).astype(np.float32)
    jobs.append(dict(program="serve", mesh=(n,), params=sp_params, x=xs))

    def finish(res) -> str:
        nnz = {}
        for (label, _, op), out in zip(products, res):
            got = CSR(*out[0]["csr"])
            assert_csr_allclose(got, spgemm_scipy(op, op), rtol=1e-5, atol=1e-6)
            nnz[label] = got.nnz
        i = len(products)
        tri = [r["count"] for r in res[i]]
        tri_want = triangle_count(gtri, backend="scipy")
        if tri != [tri_want] * n:
            raise RuntimeError(f"triangles_sharded {tri}, scipy {tri_want}")
        mcl_ref = markov_cluster(gmcl, iters=3, backend="scipy")
        n_clusters = len(mcl_clusters(mcl_ref))
        for loop, out in zip(("host", "device"), res[i + 1:i + 3]):
            for r in out:
                got = CSR(*r["csr"])
                if got.nnz != mcl_ref.nnz or len(mcl_clusters(got)) != n_clusters:
                    raise RuntimeError(f"mcl_sharded ({loop} loop): nnz {got.nnz}, clusters "
                                       f"{len(mcl_clusters(got))}; scipy {mcl_ref.nnz}, "
                                       f"{n_clusters}")
                np.testing.assert_allclose(got.to_dense(), mcl_ref.to_dense(), rtol=1e-4,
                                           atol=1e-5)
            if loop == "device" and not out[0]["report"]["fast_path"]:
                raise RuntimeError("mcl_sharded (device loop) left its fast path")
        # the train loss against one step of the same parameters on one rank
        loss = res[i + 3][0]["losses"][0]
        model = train.load_model("MLP1", sd, device=device)
        dev = model.dense[0].weight.device
        want = float(train.train_step(model, train.make_optimizer(model, cfg),
                                      torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev),
                                      cfg)[0])
        if not (np.isfinite(loss) and abs(loss - want) <= 1e-5 * max(abs(want), 1.0)):
            raise RuntimeError(f"train loss {loss} on the mesh, {want} on one rank")
        single = SparseMLP(sp_params, device=device)(xs).cpu().numpy()
        for r in res[i + 4]:
            if not np.array_equal(r["logits"], single):
                raise RuntimeError("sharded serving drifted from the single-device forward")
        return (f"dryrun_multichip OK: mesh dp={dp} tp={tp}, train loss={loss:.4f} (one rank "
                f"{want:.4f}), sharded spgemm nnz={nnz['sharded']}, 2-D ({kx}x{ny}) spgemm "
                f"nnz={nnz['2-D']}, pallas-tiled sharded nnz={nnz['tiled 1-D']} (1-D) / "
                f"{nnz['tiled 2-D']} (2-D), rebased 2^32-key nnz={nnz['rebased']} (exact), "
                f"triangles_sharded={tri_want} (exact), mcl_sharded nnz={mcl_ref.nnz} "
                f"clusters={n_clusters} (exact, host and device loops), sparse-serving dp={n} "
                f"bit-identical")

    return jobs, finish


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="outerspace_tpu_torch.shard.dryrun")
    p.add_argument("n", type=int)
    p.add_argument("--backend", default="gloo", choices=["nccl", "gloo"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, backend=args.backend, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
