"""Device operators of the PyTorch/CUDA port: the int32 (min,+) algebra, the
flankless primary sweep and the TSM kind modules, each with a plain torch
version and, where the JAX package has a Pallas kernel, a CUDA kernel."""
