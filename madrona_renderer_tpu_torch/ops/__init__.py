"""Render operators: the prologue as torch ops and the CUDA kernels."""
