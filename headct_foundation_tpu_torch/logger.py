"""Per-process logger (reference: logger.py:7-33), a copy of the JAX
package's ``logger.py:16 create_logger``.

A file handler per process (``log_rank{r}_{name}.txt``) and colored console
output on rank 0 only, memoized.
"""

from __future__ import annotations

import functools
import logging
import os
import sys


@functools.lru_cache()
def create_logger(output_dir: str, dist_rank: int = 0, name: str = "") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.propagate = False

    fmt = "[%(asctime)s %(name)s] (%(filename)s %(lineno)d): %(levelname)s %(message)s"
    color_fmt = ("\033[32m[%(asctime)s %(name)s]\033[0m"
                 "\033[33m(%(filename)s %(lineno)d)\033[0m: %(levelname)s %(message)s")

    if dist_rank == 0:
        console_handler = logging.StreamHandler(sys.stdout)
        console_handler.setLevel(logging.DEBUG)
        console_handler.setFormatter(logging.Formatter(fmt=color_fmt, datefmt="%Y-%m-%d %H:%M:%S"))
        logger.addHandler(console_handler)

    os.makedirs(output_dir, exist_ok=True)
    file_handler = logging.FileHandler(
        os.path.join(output_dir, f"log_rank{dist_rank}_{name}.txt"), mode="a")
    file_handler.setLevel(logging.DEBUG)
    file_handler.setFormatter(logging.Formatter(fmt=fmt, datefmt="%Y-%m-%d %H:%M:%S"))
    logger.addHandler(file_handler)
    return logger
