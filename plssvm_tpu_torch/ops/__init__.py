"""Device ops: the plain PyTorch Gram matvecs, the CUDA kernel wrappers and
predict."""
