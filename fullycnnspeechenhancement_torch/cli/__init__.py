"""Command-line entry points mirroring the reference's scripts, driven by
the same INI config files: `train`, `test`, `infer`, `stream` and
`export`."""

from __future__ import annotations

import logging
import os
import time


def setup_file_logger(log_dir: str, tag: str) -> logging.Logger:
    """Timestamped per-run log file plus the console (reference
    train.py:34-44).  Handlers of an earlier call for the same tag are
    closed and replaced."""
    os.makedirs(log_dir, exist_ok=True)
    name = time.asctime().replace(":", "-").replace(" ", "_")
    logger = logging.getLogger(tag)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    handler = logging.FileHandler(
        os.path.join(log_dir, f"{tag}_{name}_log.txt"), mode="w"
    )
    handler.setFormatter(
        logging.Formatter("%(asctime)s - %(name)s - %(levelname)s - %(message)s")
    )
    logger.addHandler(handler)
    logger.addHandler(logging.StreamHandler())
    return logger
