"""WindVE embedding serving on PyTorch, with hand-written CUDA kernels for
NVIDIA Hopper.

The package mirrors the layout of the JAX reference package ``repro`` so
each module's counterpart is easy to find, but it imports nothing from it:
the framework-free scheduling core is kept here as its own copy.  Entry
points take an explicit ``device`` (default ``"cuda"``); on a CUDA tensor
every kernel wrapper launches its kernel or raises, and the plain PyTorch
version of a kernel runs only for tensors on the CPU.
"""
