"""Attention kernels: hand-written CUDA for the card, plain PyTorch
versions for the CPU (see ``ops``)."""
