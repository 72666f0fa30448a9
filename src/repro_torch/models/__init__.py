"""PyTorch model zoo (dense decoder path)."""
