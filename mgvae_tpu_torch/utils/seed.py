"""Seeding, copy of ``mgvae_tpu/utils/seed.py`` (the reference's
utils/random_seed.py).

Every random draw of the port comes from an explicit ``torch.Generator``
(the trainer's is seeded ``seed + 1``) or numpy ``default_rng``, so this
helper seeds only the host-side libraries (python, numpy, the hash seed)
for data-pipeline determinism.
"""
import os
import random

import numpy as np


def set_seed(seed: int = 0):
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return seed
