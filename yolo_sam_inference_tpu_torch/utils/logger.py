"""Logging setup (capability parity with reference ``utils/logger.py:3-17``).
A copy of the JAX package's ``utils/logger.py``, which the port may not import."""

import logging


def setup_logger(name: str = "yolo_sam_inference_tpu", level: int = logging.INFO) -> logging.Logger:
    """Return a configured logger.

    Unlike the reference (which calls ``logging.basicConfig`` globally), we
    configure only our own logger so embedding applications keep control of
    the root logger.
    """
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(
            logging.Formatter("%(asctime)s - %(levelname)s - %(message)s")
        )
        logger.addHandler(handler)
    logger.setLevel(level)
    return logger
