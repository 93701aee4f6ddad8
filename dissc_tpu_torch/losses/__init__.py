"""GAN losses."""
