"""Device ops: the plain PyTorch kernel products (Gram and distance), the
CUDA kernel wrappers and predict."""
