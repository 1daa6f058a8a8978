"""Set algebra and the CUDA kernels K1 (upsample) and K2 (loss table)."""
