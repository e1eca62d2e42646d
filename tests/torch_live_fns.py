"""Step functions the ``shard.mesh.LiveWorld`` tests give their spawned
ranks: importable by name, the port's modules only."""


def failing_step():
    """Rank 2's step raises; the other ranks' wait in a barrier, as a
    rank of a collective would."""
    import torch.distributed as dist

    def step():
        if dist.get_rank() == 2:
            raise ValueError("a fault in rank 2")
        dist.barrier()

    return step
