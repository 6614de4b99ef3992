"""Arena kernels of the port: hand-written CUDA for the card, plain
PyTorch versions for the CPU (``ref``)."""
