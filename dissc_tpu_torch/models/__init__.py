"""Models: conv layers, the HiFi-GAN generator and its discriminators."""
