"""Feature-extraction API (reference surface: notebooks/extract_feature_sample.ipynb).

Port of the JAX package's ``feature_extraction.py``, following the notebook
flow (SURVEY.md section 3.4):

  1. build a bare ViT (96^3, patch 12, ViT-B, 3 channels, sincos),
  2. load pretrained weights strict=False through
     ``utils/torch_interop.load_pretrained_into``, as the JAX extractor does
     (``feature_extraction.py:75-82``): a reference ``.pt`` with its
     module./backbone./_orig_mod. prefixes (notebook cell 3), or a pickle of
     either package, an MAE or downstream one or a DINO one whose
     ``backbone`` is taken; a position embedding of another grid is
     interpolated to the model's. Without a checkpoint, a random init drawn
     from a seeded ``torch.Generator``,
  3. preprocess NIfTI scans on the device, resize BEFORE windowing,
  4. forward -> (last_layer_out [B, 513, 768], all_layers_out: 12 x same);
     CLS = last_layer_out[:, 0, :]. An input of another size than
     ``img_size`` takes its position embedding interpolated to its grid.

Attention maps (JAX ``:207-272``): ``attention_maps`` runs the forward with
``save_attn`` on (the unfused float32 softmax; no kernel is launched) and
returns each block's probabilities [B, H, T, T]; ``cls_attention_volume``
turns one layer's CLS row into a map over the input volume, through the
module-level ``cls_attention_grid``.

Runs on ``cuda`` unless ``device="cpu"`` is passed; with no device and no
CUDA it raises. On CUDA, float32 matmuls and convolutions are pinned to full
float32 (``allow_tf32 = False`` for both cuBLAS and cuDNN): the forward is
float32, as the JAX package's default ``dtype=jnp.float32`` is.
"""

from __future__ import annotations

import logging
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from headct_foundation_tpu_torch.data.device_preprocess import DevicePreprocessor, Source
from headct_foundation_tpu_torch.models.vit import ViT
from headct_foundation_tpu_torch.utils.torch_interop import load_pretrained_into

log = logging.getLogger(__name__)


def resolve_device(device: Union[None, str, torch.device]) -> torch.device:
    """The explicit device, else ``cuda``; raises when CUDA is needed and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: the port runs on an NVIDIA GPU by default; "
                "pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class FeatureExtractor:
    """Bare ViT feature extractor with notebook-order preprocessing."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        img_size: int = 96,
        patch_size: int = 12,
        in_chans: int = 3,
        hidden_size: int = 768,
        mlp_dim: int = 3072,
        num_layers: int = 12,
        num_heads: int = 12,
        pos_embed: str = "sincos",
        num_register_tokens: int = 0,
        qkv_bias: bool = True,
        norm_layer: str = "layernorm",
        device: Union[None, str, torch.device] = None,
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        self.img_size = img_size
        self.in_chans = in_chans
        model = ViT(
            in_chans=in_chans,
            img_size=img_size,
            patch_size=patch_size,
            hidden_size=hidden_size,
            mlp_dim=mlp_dim,
            num_layers=num_layers,
            num_heads=num_heads,
            pos_embed=pos_embed,
            classification=False,
            num_register_tokens=num_register_tokens,
            qkv_bias=qkv_bias,
            norm_layer=norm_layer,
        )
        model.init_weights(torch.Generator().manual_seed(seed))
        self.missing: List[str] = []
        self.unexpected: List[str] = []
        if checkpoint_path:
            self.missing, self.unexpected = load_pretrained_into(model, checkpoint_path,
                                                                 logger=log)
        self.model = model.to(self.device).eval()
        self._prep = DevicePreprocessor((img_size,) * 3, in_chans, self.device)

    def preprocess(self, source: Source) -> torch.Tensor:
        """NIfTI path or bytes -> [C, R, R, R] float32 on the extractor's device."""
        return self._prep(source)

    def _input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x).to(self.device, torch.float32)
        return x[None] if x.dim() == 4 else x

    def __call__(self, x) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """[B, C, R, R, R] (or one [C, R, R, R]) -> (last_layer_out [B, T, C],
        all_layers_out). Tensors already on the device are used in place."""
        x = self._input(x)
        with torch.inference_mode():
            return self.model(x)

    def cls_embedding(self, x) -> np.ndarray:
        out, _ = self(x)
        return out[:, 0, :].cpu().numpy()

    def extract_from_files(
        self, paths: Sequence[str], batch_size: int = 8, prefetch: int = 2,
        workers: int = 3,
    ) -> np.ndarray:
        """NIfTI paths -> CLS embeddings [N, hidden], in path order.

        ``workers`` threads decode and preprocess scans ahead of the forward
        (the gzip inflate is the main host cost); ``prefetch`` bounds the
        look-ahead in batches."""
        feats: List[np.ndarray] = []
        batch: List[torch.Tensor] = []

        def flush():
            if batch:
                feats.append(self.cls_embedding(torch.stack(batch)))
                batch.clear()

        window = max(1, prefetch) * batch_size
        path_iter = iter(paths)
        futures: deque = deque()
        with ThreadPoolExecutor(max_workers=max(1, workers),
                                thread_name_prefix="headct-extract") as pool:
            def top_up():
                while len(futures) < window:
                    p = next(path_iter, None)
                    if p is None:
                        return
                    futures.append(pool.submit(self.preprocess, p))

            top_up()
            while futures:
                batch.append(futures.popleft().result())
                top_up()
                if len(batch) == batch_size:
                    flush()
            flush()
        if feats:
            return np.concatenate(feats, axis=0)
        return np.zeros((0, self.model.hidden_size), np.float32)

    def attention_maps(self, x) -> List[np.ndarray]:
        """Each block's post-softmax attention [B, H, T, T] float32, as numpy
        (the reference's ``save_attn`` surface, src/models/attentionblock.py:36,
        62-64): the forward runs unfused with ``save_attn`` on, so no kernel
        is launched."""
        x = self._input(x)
        prev = self.model.set_save_attn(True)
        try:
            with torch.inference_mode():
                self.model(x)
            return [blk.attn.att_mat.cpu().numpy() for blk in self.model.blocks]
        finally:
            self.model.set_save_attn(prev)

    @property
    def token_grid(self) -> Tuple[int, int, int]:
        """Patch-token grid (tokens per spatial axis)."""
        return tuple(self.img_size // p for p in self.model.patch_size)

    def cls_attention_volume(self, x, layer: int = -1, head: Optional[int] = None
                             ) -> np.ndarray:
        """CLS-to-patch attention of one layer over the input volume:
        [B or none, C, R, R, R] -> [B, R, R, R] float32, the CLS row of that
        layer's attention (mean over heads, or one ``head``) on the patch
        grid, repeated (nearest neighbour) to the volume's resolution."""
        att = cls_attention_grid(self.attention_maps(x), self.token_grid,
                                 num_register_tokens=self.model.num_register_tokens,
                                 layer=layer, head=head)
        for axis, g in enumerate(self.token_grid):
            att = np.repeat(att, self.img_size // g, axis=axis + 1)
        return att


def cls_attention_grid(att_maps: Sequence[np.ndarray], grid: Sequence[int],
                       num_register_tokens: int = 0, layer: int = -1,
                       head: Optional[int] = None) -> np.ndarray:
    """Per-layer [B, H, T, T] attention -> [B, *grid] CLS-to-patch maps. The
    tokens are [CLS, registers..., patches...] (``ViT.forward``), so the CLS
    query row skips itself and the registers before it is laid on the grid."""
    m = np.asarray(att_maps[layer])
    cls_row = m[:, :, 0, 1 + int(num_register_tokens):]  # [B, H, P]
    att = cls_row.mean(axis=1) if head is None else cls_row[:, head]
    grid = tuple(int(g) for g in grid)
    if att.shape[1] != int(np.prod(grid)):
        raise ValueError(f"{att.shape[1]} patch tokens do not fill the grid {grid}")
    return att.reshape(att.shape[0], *grid).astype(np.float32)


def build_extractor_from_config(config, checkpoint_path: Optional[str] = None,
                                **kwargs) -> FeatureExtractor:
    return FeatureExtractor(
        checkpoint_path=checkpoint_path,
        img_size=config.VIT.INPUT_SIZE,
        patch_size=config.VIT.PATCH_SIZE,
        in_chans=config.VIT.IN_CHANS,
        hidden_size=config.VIT.HIDDEN_SIZE,
        mlp_dim=config.VIT.MLP_DIM,
        num_layers=config.VIT.NUM_LAYERS,
        num_heads=config.VIT.NUM_HEADS,
        pos_embed=config.VIT.POS_EMBED,
        num_register_tokens=config.VIT.NUM_REGISTER_TOKENS,
        qkv_bias=config.VIT.USE_BIAS,
        norm_layer=config.VIT.NORM_LAYER,
        **kwargs,
    )
