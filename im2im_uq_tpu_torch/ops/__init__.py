"""Set algebra, losses and the CUDA kernels K1f/K1b (upsample), K2 (loss
table), K3/K4 (3x3 conv and its fused BatchNorm form), K5/K6 (its weight
and input gradients) and K7 (max-pool backward)."""
