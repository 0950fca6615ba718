"""Tensor operations of the port: GF(2) algebra, BP, device OSD and the
wrappers of the hand-written CUDA kernels."""
