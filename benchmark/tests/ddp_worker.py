"""One rank of a tiny data-parallel cell on gloo (CPU), for the tests:

    python -m benchmark.tests.ddp_worker RANK WORLD PORT FAULT OUT

``FAULT`` "none" or "no_exchange" (the port's average over the ranks
replaced by nothing). Rank 0 writes the compared numbers to ``OUT``."""

import json
import os
import sys

import torch


def main(rank: int, world: int, port: int, fault: str, out: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    torch.set_num_threads(2)
    import torch.distributed as dist
    from benchmark import compare, harness
    from benchmark.tests.tiny import tiny_cell
    from headct_foundation_tpu_torch.parallel import distributed

    cell = tiny_cell("mae", name="mae-vitb12.96.b64.ddp4")
    cell.chips = world
    distributed.init_from_env("cpu", config=harness.port_config(cell.run_config()))
    group = dist.new_group(backend="gloo")
    if fault == "no_exchange":
        distributed.data_mean_ = lambda tensors, sharded=(): None

    def agree(flag):
        t = torch.tensor([int(flag)])
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return bool(t.item())

    def all_reduce(ts):
        for t in ts:
            dist.all_reduce(t)
            t.div_(world)

    res = harness.run_rank(cell, 2 ** 32 + 5, 0.5, False, torch.device("cpu"), rank, world,
                           agree, lambda: dist.barrier(group=group), all_reduce)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"gaps": compare.gaps(res.readings, res.reference),
                       "limits": cell.limits, "steps": res.steps}, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5])
