# The bge/jina embedder trunk in plain PyTorch around the port's kernels.
