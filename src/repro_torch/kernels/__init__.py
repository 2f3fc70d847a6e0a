"""Hand-written CUDA kernels of the port, their plain PyTorch versions
(``ref``) and the dispatch surface (``ops``)."""
