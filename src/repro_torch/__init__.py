"""PyTorch/CUDA port of the TIFU-kNN maintain-and-serve system.

Laid out like the JAX package ``repro`` so each module's counterpart is
easy to find; it imports neither JAX nor ``repro``.  Entry points run on
the CUDA device unless the caller passes ``device="cpu"``; on CPU tensors
``kernels.ops`` runs each kernel's plain PyTorch version.
"""
