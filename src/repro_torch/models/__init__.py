"""The model zoo: the JAX package's ``models`` on PyTorch tensors."""
