"""Hand-written CUDA kernels for the H100, their plain PyTorch versions
(``ref``) and the dispatch between them (``ops``)."""
