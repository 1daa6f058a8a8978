"""im2im_uq_tpu_torch — the PyTorch and CUDA port of im2im_uq_tpu.

The port runs on an NVIDIA H100: the JAX package's Pallas TPU kernels on
this path are hand-written CUDA kernels here (``csrc/``, built at first use
by ``_build.py``), and the rest is PyTorch. Module paths mirror the JAX
package. The public entry points take and return the JAX package's layouts
(NHWC numpy images, (N, L) loss tables); tensors inside are NCHW.

This package imports no JAX. Of the JAX package it imports only the host
modules that import no JAX either: ``calibration.bounds``, ``data.core``,
``data.synthetic``, ``utils.config`` and ``interop.torch_export``.
"""

__version__ = "0.1.0"
