"""Runnable examples of the port (``python -m mgvae_tpu_torch.examples.<name>``)."""
