"""Attention and sampling ops of the port: plain PyTorch references and
the hand-written CUDA kernels beside them."""
