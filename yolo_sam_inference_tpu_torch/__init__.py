"""PyTorch + CUDA port of ``yolo_sam_inference_tpu`` for NVIDIA Hopper GPUs.

The layout mirrors the JAX package (``models/yolo``, ``models/sam``, ``ops``,
``pipeline``). The port imports ``torch`` and never ``jax`` nor the JAX
package. Kernels written by hand for the card live in ``csrc/`` (CUDA C++);
each wrapper in ``ops/`` sits beside its plain PyTorch version, which CPU
tensors take.
"""
