"""The benchmark of the PyTorch and CUDA port (``rubiksnet_torch``): one
command runs one cell once; see ``README.md``."""
