"""Checkpoints of trees of tensors and arrays (``checkpoint``)."""
