"""HiFiGAN generator (resblock 1) inference."""
