"""backends of the PyTorch/CUDA port."""
