"""Plain PyTorch references of the benchmark's training steps.

Float32 throughout, TF32 off, no kernel, no cache, nothing of the measured
package: the MAE step (``mae.py``) and the DINO step (``dino.py``) written
from the published recipes (nirvanesque/headCT_foundation, arXiv
2502.02779) over ``common.py``'s layers, windowing, augmentation, AdamW and
schedules. ``train.py`` follows a cell's first steps from the seed's weights
and draws, in blocks of rows, and returns the readings that decide
``correct``. ``precision="fp8"`` is the control: every matrix product's
operands rounded to float8 e4m3 with a per-tensor scale.
"""
