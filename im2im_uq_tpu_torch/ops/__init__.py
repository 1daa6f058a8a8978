"""Set algebra, losses and the CUDA kernels K1f/K1b (upsample), K2 (loss
table), K3/K4 (3x3 conv and its fused BatchNorm form), K5/K6 (its weight
and input gradients), K7 (max-pool backward), and the ports of the Pallas
probes: P1 (per-channel moments) and P2-P5 (bias-free NHWC 3x3 conv)."""
