"""Losses and the train/eval steps of the port."""
