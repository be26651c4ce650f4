"""The plain reference that decides ``correct``: NumPy and plain PyTorch
only, nothing of the port, JAX or the JAX package. It works out its own
Gram-Schmidt data from the loaded integer bases and judges the program's
answers by them."""
