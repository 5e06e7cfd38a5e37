"""EarlyTrainer: Trainer with patience / delta early stopping on the
validation loss.

Counterpart of ``mgvae_tpu/train/trainer_early_stop.py`` (the reference's
trainer_early_stop.py:21-309, with its distributed fault repaired: there
rank 0 decides and broadcasts a flag the other ranks never receive). The
criterion reads the metrics of ``Trainer.train``, which under data
parallelism are already averaged over the group inside the step, so every
rank reaches the same decision with no message of its own. Only the chief
writes ``model_best.pth`` (``Trainer.save``).
"""
from __future__ import annotations

import os

from .trainer import Trainer


class EarlyTrainer(Trainer):
    def __init__(self, *args, patience: int = 10, delta: float = 0.0002, **kwargs):
        super().__init__(*args, **kwargs)
        self.patience = patience
        self.delta = delta
        self.best_loss = float("inf")
        self.early_stop_counter = 0
        self.early_stop = False

    def train(self, num_epoch: int, train_dataset, val_dataset):
        last = {}
        for epoch in range(num_epoch):
            # one epoch of train and val; the val phase's meter averages
            last = super().train(1, train_dataset, val_dataset)
            current_val_loss = last["recon"] + last["prob"] + last["func"]
            if current_val_loss < self.best_loss - self.delta:
                self.best_loss = current_val_loss
                self.early_stop_counter = 0
                self.save(os.path.join(self.log_dir, "model_best.pth"))
                if self.is_chief:
                    print(f"[INFO] Validation loss improved to {self.best_loss:.4f}")
            else:
                self.early_stop_counter += 1
                if self.is_chief:
                    print(f"[INFO] Early stop counter: {self.early_stop_counter}/{self.patience}")
            if self.early_stop_counter >= self.patience:
                self.early_stop = True
                if self.is_chief:
                    print(f"[INFO] Early stopping at epoch {epoch + 1}/{num_epoch}")
                break
        return last
