"""PyTorch / CUDA port of ``headct_foundation_tpu`` for NVIDIA Hopper GPUs.

The JAX package beside this one is the reference; this package imports
nothing of it and nothing of JAX. Ported so far: the embedding server path
(NIfTI -> on-device preprocessing -> ViT-B/12 at 96^3 -> CLS embedding), the
MAE pretraining step at 96^3 and 192^3 (``engines/mae_engine.py``) with the
optimizer zoo (SGD, AdamW, Lamb, Lion) and the per-parameter gradient clip,
and the token-major attention A/B tool (``tools/``). Each TPU kernel of the
JAX repository is a CUDA C++ kernel in ``csrc/`` built with ``nvcc`` for
``sm_90a`` at first use.

Entry points (``FeatureExtractor``, ``serve_features.main``,
``engines.mae_engine.create_train_state``) run on ``cuda`` unless the caller
passes ``device="cpu"``.
"""
