"""Hand-written CUDA kernels for Hopper and their wrappers — the counterpart
of the JAX package's ops/pallas/. Every kernel has a plain PyTorch version
in the same module; the wrappers run it for CPU tensors only."""
