"""Model FLOPs per volume (3 x the trained forward's matrix products, plus
DINO's teacher forward; ``counts.model_flops_per_volume`` from the cell's
shapes) x ``train_volumes_per_s`` over the card's dense bf16 peak, in %."""

from benchmark import counts


def read(run):
    peak = run.peak
    if peak is None:
        return None
    flops = counts.model_flops_per_volume(run.cell.engine, run.run_cfg)
    return 100.0 * flops * run.volumes_per_s / peak["bf16_flops"]
