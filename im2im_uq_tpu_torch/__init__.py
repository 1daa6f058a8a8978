"""im2im_uq_tpu_torch — the PyTorch and CUDA port of im2im_uq_tpu.

The port runs on an NVIDIA H100: the JAX package's Pallas TPU kernels on
this path are hand-written CUDA kernels here (``csrc/``, built at first use
by ``_build.py``), and the rest is PyTorch. Module paths mirror the JAX
package. The public entry points take and return the JAX package's layouts
(NHWC numpy images, (N, L) loss tables); tensors inside are NCHW.

This package imports no JAX and nothing of the JAX package: the host
modules it shares with it (``calibration.bounds``, ``data/``,
``utils.config``, ``utils.logging`` and the weight layout of
``interop.torch_export``) are copies kept here.
"""

__version__ = "0.1.0"
