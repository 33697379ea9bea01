"""robustness of the PyTorch/CUDA port."""
