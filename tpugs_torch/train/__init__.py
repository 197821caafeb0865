"""Training: the L1 + SSIM loss and the single-device Trainer."""
