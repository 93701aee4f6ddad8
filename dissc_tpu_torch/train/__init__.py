"""Training: checkpoints and the vocoder GAN step."""
