"""CLIP text encoder, conditional UNet and VAE decoder."""
