"""Hand-written Hopper kernels (``repro_torch/csrc/``), their ctypes wrappers
(``cuda``), their plain PyTorch versions (``ref``) and the dispatch between
them (``ops``).  Importing this package builds and loads nothing: a kernel
library builds at its first launch."""
