"""``python -m mgvae_tpu_torch.train``: the 3-stage training CLI
(``mgvae_tpu_torch/cli.py``)."""
from ..cli import main

if __name__ == "__main__":
    main()
