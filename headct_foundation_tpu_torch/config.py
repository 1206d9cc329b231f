"""Configuration system (the PyTorch port's own copy of the JAX package's
``config.py``; the port imports nothing of the JAX package).

A lightweight, yacs-compatible config tree. The reference uses yacs
``CfgNode`` (reference: config.py:6-273); yacs is not available in this
environment, so ``CfgNode`` below re-implements the subset of semantics the
reference relies on:

* attribute-style access over a nested dict tree,
* ``clone`` / ``defrost`` / ``freeze``,
* ``merge_from_file`` (type-checked, recursive ``BASE`` includes,
  reference: config.py:175-177),
* ``merge_from_list`` for ``--opts KEY VALUE ...`` pairs,
* named-CLI-arg override of selected fields (reference: config.py:182-259).

All key names are kept identical to the reference so that its shipped YAML
configs (configs/{mae,dino,downstream}/*.yaml) parse unchanged.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, List

import yaml


class CfgNode(dict):
    """A dict subclass with attribute access and freeze semantics."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(
                f"Attempted to set {name} to {value}, but CfgNode is immutable"
            )
        self[name] = value

    # -- freeze / clone -----------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    def clone(self) -> "CfgNode":
        frozen = self.is_frozen()
        self._set_immutable(False)
        out = copy.deepcopy(self)
        self._set_immutable(frozen)
        out._set_immutable(False)
        return out

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: Dict[str, Any], prefix: str = "") -> None:
        was_frozen = self.is_frozen()
        if was_frozen:
            self.defrost()
        for k, v in other.items():
            full = f"{prefix}.{k}" if prefix else k
            if k == "BASE":
                continue
            if k not in self:
                raise KeyError(f"Non-existent config key: {full}")
            if isinstance(v, dict):
                if not isinstance(self[k], CfgNode):
                    raise TypeError(f"Cannot merge dict into non-dict key {full}")
                self[k].merge_from_dict(v, prefix=full)
            else:
                self[k] = _coerce(v, self[k], full)
        if was_frozen:
            self.freeze()

    def merge_from_file(self, cfg_file: str) -> None:
        """Merge a YAML file, honoring recursive ``BASE`` includes first."""
        with open(cfg_file, "r") as f:
            yaml_cfg = yaml.safe_load(f) or {}
        for base in yaml_cfg.get("BASE", [""]):
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(cfg_file), base))
        self.merge_from_dict(yaml_cfg)

    def merge_from_list(self, opts: List[Any]) -> None:
        assert len(opts) % 2 == 0, f"--opts must be KEY VALUE pairs, got {opts}"
        was_frozen = self.is_frozen()
        if was_frozen:
            self.defrost()
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Non-existent config key: {key}")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Non-existent config key: {key}")
            if isinstance(value, str):
                value = _decode_value(value)
            node[leaf] = _coerce(value, node[leaf], key)
        if was_frozen:
            self.freeze()

    # -- dumping ------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, CfgNode) else v) for k, v in self.items()
        }

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), default_flow_style=False)


def _decode_value(s: str) -> Any:
    """Parse a CLI string value into a Python literal where possible."""
    try:
        return yaml.safe_load(s)
    except yaml.YAMLError:
        return s


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Type-check a replacement value against the default (yacs semantics)."""
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        raise TypeError(f"Type mismatch for {key}: expected bool, got {type(value)}")
    if isinstance(old, float) and isinstance(value, (int, float)):
        return float(value)
    # PyYAML parses dot-less scientific notation ('5e-4') as a string;
    # coerce numeric strings into numeric fields.
    if isinstance(old, float) and isinstance(value, str):
        try:
            return float(value)
        except ValueError:
            pass
    if isinstance(old, int) and isinstance(value, str):
        try:
            return int(value)
        except ValueError:
            pass
    if isinstance(old, int) and isinstance(value, int):
        return value
    if isinstance(old, str):
        # the reference stores 'None' sentinels as strings in some fields
        return str(value)
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return list(value)
    if type(old) is type(value):
        return value
    raise TypeError(
        f"Type mismatch for {key}: expected {type(old).__name__}, "
        f"got {type(value).__name__} ({value!r})"
    )


# ---------------------------------------------------------------------------
# Default config tree — key names identical to reference config.py:6-161.
# ---------------------------------------------------------------------------

def _default_config() -> CfgNode:
    _C = CfgNode()
    _C.BASE = [""]

    # Data settings (reference: config.py:14-27)
    _C.DATA = CfgNode()
    _C.DATA.BATCH_SIZE = 64
    _C.DATA.BASE_PATH = "<path-to>/datasets"
    _C.DATA.TRAIN_CSV_PATH = "<path-to>/datasets/train.csv"
    _C.DATA.VAL_CSV_PATH = "<path-to>/datasets/val.csv"
    _C.DATA.TEST_CSV_PATH = "<path-to>/datasets/test.csv"
    _C.DATA.PIN_MEMORY = True
    _C.DATA.NUM_WORKERS = 4
    _C.DATA.CACHE_NUM = -1
    _C.DATA.CACHE_RATE = 1.0
    _C.DATA.CACHE_DIR = "<path-to>/cache_dir"
    _C.DATA.DATASET = "nyu"
    _C.DATA.FEW_SHOTS = -1
    _C.DATA.NUM_CLASSES = 2
    # Cache/wire tensor format: 'windowed' = fp16 [C, roi] fully windowed
    # volumes (exact reference training-cache parity); 'hu16' = int16
    # [1, roi] fixed-point HU, expanded to the window stack ON DEVICE inside
    # the jitted steps — 3x fewer H2D bytes, the shipped production path
    # (see data/transforms.py hu16 notes + MIGRATION.md); 'hu8' = uint8
    # [1, roi] companded HU, 6x fewer bytes — OPT-IN lossy (soft-tissue
    # windows keep 1-HU steps, bone window coarsens to ~63 HU; bounds in
    # data/transforms.py hu8 notes) for transport-starved mounts; 'auto' =
    # probe the H2D bandwidth once at startup and pick hu8 below
    # DATA.WIRE_AUTO_MBPS, hu16 otherwise (data/pipeline.resolve_wire_format).
    _C.DATA.WIRE_FORMAT = "windowed"
    # 'auto' threshold: below this measured H2D MB/s the loader is
    # transport-bound and hu8's halved bytes beat its precision cost
    # (equivalence study: wire_equivalence.json)
    _C.DATA.WIRE_AUTO_MBPS = 150.0

    # General model settings (reference: config.py:32-38)
    _C.MODEL = CfgNode()
    _C.MODEL.NAME = "mae"
    _C.MODEL.PRETRAINED = None
    _C.MODEL.DIR = "<path-to>/model_saved"
    _C.MODEL.SAVE_NAME = "debug.pt"
    _C.MODEL.ROI = [96, 96, 96]
    _C.MODEL.IN_CHANS = 3

    # MAE settings (reference: config.py:43-66)
    _C.MAE = CfgNode()
    _C.MAE.INPUT_SIZE = 96
    _C.MAE.PATCH_SIZE = 16
    _C.MAE.MASK_RATIO = 0.75
    _C.MAE.IN_CHANS = 3
    _C.MAE.DROPOUT_RATE = 0.0
    _C.MAE.PATCH_EMBED = "conv"
    _C.MAE.POS_EMBED = "sincos"
    _C.MAE.NORM_LAYER = "layernorm"
    _C.MAE.SPATIAL_DIMS = 3
    _C.MAE.NORM_PIX_LOSS = False
    # Loss-path dtype: 'bfloat16' halves the bandwidth of the patchified
    # target/diff tensors (reductions still accumulate in f32).
    _C.MAE.LOSS_DTYPE = "float32"
    _C.MAE.RETURN_IMAGE = False
    _C.MAE.ENCODER_EMBED_DIM = 768
    _C.MAE.ENCODER_DEPTH = 12
    _C.MAE.ENCODER_MLP_DIM = 3072
    _C.MAE.ENCODER_NUM_HEADS = 12
    _C.MAE.DECODER_EMBED_DIM = 768
    _C.MAE.DECODER_DEPTH = 8
    _C.MAE.DECODER_MLP_DIM = 2048
    _C.MAE.DECODER_NUM_HEADS = 16
    _C.MAE.USE_BIAS = False

    # DINO settings (reference: config.py:71-88)
    _C.DINO = CfgNode()
    _C.DINO.GLOBAL_CROP_SIZE = [112, 112, 112]
    _C.DINO.GLOBAL_CROP_NUM = 2
    _C.DINO.LOCAL_CROP_SIZE = [64, 64, 64]
    _C.DINO.LOCAL_CROP_NUM = 2
    _C.DINO.HEAD_N_LAYERS = 3
    _C.DINO.HEAD_N_PROTOTYPES = 65536
    _C.DINO.BOTTLENECK_DIM = 256
    _C.DINO.HEAD_HIDDEN_DIM = 2048
    _C.DINO.MOMENTUM_TEACHER = 0.994
    _C.DINO.MOMENTUM_TEACHER_END = 1.0
    _C.DINO.WARMUP_TEACHER_TEMP = 0.04
    _C.DINO.TEACHER_TEMP = 0.07
    _C.DINO.WARMUP_TEACHER_EPOCHS = 30
    _C.DINO.DINO_LOSS_WEIGHT = 1.0
    _C.DINO.USE_BN = True
    _C.DINO.NORM_LAST_LAYER = True
    _C.DINO.FREEZE_LAST_LAYER = 1

    # ViT settings (reference: config.py:93-113)
    _C.VIT = CfgNode()
    _C.VIT.INPUT_SIZE = 96
    _C.VIT.PATCH_SIZE = 12
    _C.VIT.IN_CHANS = 3
    _C.VIT.DROPOUT_RATE = 0.0
    _C.VIT.PATCH_EMBED = "conv"
    _C.VIT.POS_EMBED = "sincos"
    _C.VIT.NORM_LAYER = "layernorm"
    _C.VIT.SPATIAL_DIMS = 3
    _C.VIT.NUM_LAYERS = 12
    _C.VIT.NUM_HEADS = 12
    _C.VIT.HIDDEN_SIZE = 768
    _C.VIT.MLP_DIM = 3072
    _C.VIT.NUM_REGISTER_TOKENS = 0
    _C.VIT.PATCHES_OVERLAP = 0.2
    _C.VIT.POOLING = "cls"
    _C.VIT.CLASSIFICATION = False
    _C.VIT.USE_BIAS = False

    # Training settings (reference: config.py:118-137)
    _C.TRAIN = CfgNode()
    _C.TRAIN.MAX_EPOCHS = 100
    _C.TRAIN.VAL_EVERY = 10
    _C.TRAIN.BASE_LR = 1.5e-3
    _C.TRAIN.MIN_LR = 1.5e-7
    _C.TRAIN.WEIGHT_DECAY = 0.04
    _C.TRAIN.WEIGHT_DECAY_END = 0.4
    _C.TRAIN.BETA1 = 0.9
    _C.TRAIN.BETA2 = 0.95
    _C.TRAIN.MOMENTUM = 0.9
    _C.TRAIN.LOSS = "l1"
    _C.TRAIN.TEMPERATURE = 0.5
    _C.TRAIN.OPTIMIZER = "AdamW"
    # Fused Pallas Lion update kernel (counterpart of the reference Lion's
    # use_triton flag, reference: src/utils/optimizers.py:305-307).
    _C.TRAIN.LION_FUSED = False
    # Gradient accumulation: split each step's batch into N micro-batches,
    # accumulate f32 grads, apply once. TPU extension beyond the reference
    # (which has none) — matches the reference's 256-512 global batches on
    # fewer chips at micro-batch activation memory.
    _C.TRAIN.ACCUM_STEPS = 1
    # Epoch-boundary checkpoints: snapshot on device, fetch + pickle + write
    # in a background thread (the reference's torch.save is synchronous on
    # the trainer, src/utils/misc.py:35-52).
    _C.TRAIN.ASYNC_CKPT = True
    # "pickle" (single-file, torch-era UX, gathers multi-host-sharded
    # states to rank 0) or "orbax" (checkpoint directory; multi-host
    # processes write their own shards cooperatively — O(state/process),
    # measured 4.6x faster on the full ViT-B MAE state). Resume and
    # torch export accept either transparently.
    _C.TRAIN.CKPT_FORMAT = "pickle"
    _C.TRAIN.SCHEDULER = "cosine"
    _C.TRAIN.PER_WARMUP = 0.05
    _C.TRAIN.GRAD_CLIP = 1.0
    _C.TRAIN.LOCK = False
    _C.TRAIN.LORA = False
    _C.TRAIN.CLASSIFIER = "linear"
    _C.TRAIN.LABEL_NAME = "cancer"

    # Parallelism settings (TPU-native extension; data/fsdp/tensor axes of the
    # device mesh — not present in the reference, which is DDP-only,
    # reference: main_pretrain_mae.py:139)
    _C.PARALLEL = CfgNode()
    _C.PARALLEL.DATA = -1        # -1: all remaining devices on the data axis
    _C.PARALLEL.FSDP = 1         # ZeRO-style parameter sharding axis
    _C.PARALLEL.TENSOR = 1       # tensor-parallel axis (heads / mlp)
    # Context-parallel (sequence) axis: tokens shard over 'seq' and attention
    # all-gathers KV over ICI inside a shard_map (ops/attention.py). For the
    # long-sequence stretch configs (192^3 -> 4096 tokens) where activation
    # memory, not parameters, bounds the per-chip batch. Requires the Pallas
    # attention backend (the blocked kernel handles the rectangular
    # Q-shard x full-KV shapes).
    _C.PARALLEL.SEQ = 1
    # Pipeline-parallel axis: the MAE encoder/decoder trunks run as a
    # GPipe-style fill-drain pipeline of PIPE stages (parallel/pipeline.py);
    # block params are stacked [L, ...] and sharded over 'pipe' (each stage
    # holds L/PIPE layers + their optimizer state). For models whose layer
    # stack outgrows one chip's HBM. Requires FSDP=SEQ=TENSOR=1 (v1) and
    # DROPOUT_RATE=0. PIPE_MICROBATCH microbatches per step (0 = PIPE).
    _C.PARALLEL.PIPE = 1
    _C.PARALLEL.PIPE_MICROBATCH = 0
    _C.PARALLEL.REMAT = False    # rematerialize transformer blocks
    # Pallas/XLA attention crossover: sequences shorter than this use XLA's
    # fused attention (the per-(b,h)-program Pallas kernels are launch-bound
    # at tiny T; measured crossover between 129 and 513 tokens).
    # Precedence: explicit config/--opts > HEADCT_PALLAS_MIN_T env > 192
    # (the env seeds the default here so training runs honor it too — the
    # engines install the config value via set_pallas_min_t).
    _C.PARALLEL.PALLAS_MIN_T = int(os.environ.get("HEADCT_PALLAS_MIN_T", "192"))

    # Logging settings (reference: config.py:142-144)
    _C.LOG = CfgNode()
    _C.LOG.OUTPUT_DIR = "log"
    _C.LOG.FILENAME = "headct_foundation"

    # wandb settings (reference: config.py:149-151)
    _C.WANDB = CfgNode()
    _C.WANDB.WANDB_ENABLE = False
    _C.WANDB.PROJECT = "headCT_foundation"

    # Misc settings (reference: config.py:156-161)
    _C.SEED = 42
    _C.AMP_ENABLE = False
    _C.LOCAL_RANK = 0
    _C.OUTPUT = ""
    _C.TAG = "default"
    _C.PREDS_SAVE_NAME = "None"
    return _C


# Named CLI args that can override config fields, mapped to their config
# destination (reference: config.py:199-251). Falsy values are not merged —
# the reference uses ``eval(f'args.{name}')`` as the presence test
# (config.py:196-197); we keep that (documented) quirk for CLI parity.
_ARG_MAP = {
    "preds_save_name": "PREDS_SAVE_NAME",
    "dataset": "DATA.DATASET",
    "batch_size": "DATA.BATCH_SIZE",
    "few_shots": "DATA.FEW_SHOTS",
    "num_workers": "DATA.NUM_WORKERS",
    "train_csv_path": "DATA.TRAIN_CSV_PATH",
    "val_csv_path": "DATA.VAL_CSV_PATH",
    "test_csv_path": "DATA.TEST_CSV_PATH",
    "optimizer": "TRAIN.OPTIMIZER",
    "scheduler": "TRAIN.SCHEDULER",
    "max_epochs": "TRAIN.MAX_EPOCHS",
    "grad_clip": "TRAIN.GRAD_CLIP",
    "base_lr": "TRAIN.BASE_LR",
    "min_lr": "TRAIN.MIN_LR",
    "weight_decay": "TRAIN.WEIGHT_DECAY",
    "lock": "TRAIN.LOCK",
    "pooling": "VIT.POOLING",
    "seed": "SEED",
    "use_amp": "AMP_ENABLE",
    "use_wandb": "WANDB.WANDB_ENABLE",
    "wandb_project": "WANDB.PROJECT",
    "model_name": "MODEL.NAME",
    "model_load_path": "MODEL.PRETRAINED",
    "label_name": "TRAIN.LABEL_NAME",
    "classifier": "TRAIN.CLASSIFIER",
    "filename": "LOG.FILENAME",
}


def update_config(config: CfgNode, args) -> None:
    """Merge YAML file + --opts + named CLI args (reference: config.py:182-259)."""
    config.defrost()
    config.merge_from_file(args.cfg)

    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)

    for arg_name, cfg_key in _ARG_MAP.items():
        value = getattr(args, arg_name, None)
        if not value:  # reference parity: falsy values are not merged
            continue
        node = config
        parts = cfg_key.split(".")
        for p in parts[:-1]:
            node = node[p]
        node[parts[-1]] = value

    config.LOCAL_RANK = getattr(args, "local_rank", 0)
    config.OUTPUT = os.path.join(config.OUTPUT) if config.OUTPUT else ""
    config.freeze()


def get_config(args) -> CfgNode:
    """Build the merged config for a CLI invocation (reference: config.py:261-273)."""
    config = _default_config()
    update_config(config, args)
    return config


def default_config() -> CfgNode:
    """A fresh, mutable default config (useful for tests and notebooks)."""
    return _default_config()
