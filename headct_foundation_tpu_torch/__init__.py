"""PyTorch / CUDA port of ``headct_foundation_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: the embedding server path
(NIfTI -> on-device preprocessing -> ViT-B/12 at 96^3 -> CLS embedding),
whose one TPU kernel, the whole-sequence forward attention, is a CUDA C++
kernel in ``csrc/`` built with ``nvcc`` for ``sm_90a`` at first use.

Entry points (``FeatureExtractor``, ``serve_features.main``) run on
``cuda`` unless the caller passes ``device="cpu"``.
"""
