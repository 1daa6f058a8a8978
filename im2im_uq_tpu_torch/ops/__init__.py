"""Set algebra, losses and the CUDA kernels K1f/K1b (upsample), K2 (loss
table) and K7 (max-pool backward)."""
