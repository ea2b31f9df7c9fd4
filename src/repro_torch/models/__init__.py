"""Attention-decoder model path in PyTorch (dense GQA, paged serving)."""
