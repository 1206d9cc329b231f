"""A cell cut to a size the CPU runs in seconds (the tests' stand-in)."""

import copy

from benchmark import cells


def tiny_cell(engine: str, batch: int = 4, name: str = None):
    cell = cells.find(name or ("mae-vitb12.96.b64" if engine == "mae" else "dino-vitb12.96.b64"))
    c = copy.deepcopy(cell.config)
    if engine == "mae":
        c["config"]["MAE"].update(ENCODER_EMBED_DIM=48, ENCODER_DEPTH=2, ENCODER_MLP_DIM=96,
                                  ENCODER_NUM_HEADS=4, DECODER_EMBED_DIM=48, DECODER_DEPTH=1,
                                  DECODER_MLP_DIM=96, DECODER_NUM_HEADS=4)
    else:
        c["config"]["VIT"].update(HIDDEN_SIZE=48, NUM_LAYERS=2, MLP_DIM=96, NUM_HEADS=4)
        c["config"]["DINO"].update(HEAD_N_PROTOTYPES=64, HEAD_HIDDEN_DIM=32, BOTTLENECK_DIM=16)
    cell.config = c
    cell.traffic = dict(cell.traffic, input_size=24, batch=batch, trace_steps=2, ref_rows=2)
    return cell
