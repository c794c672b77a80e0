"""PyTorch + CUDA port of the sparsely-gated Mixture-of-Experts repro.

Laid out module for module like ``repro`` (the JAX package, which stays
the reference): ``common/``, ``configs/``, ``core/``, ``kernels/``,
``models/``, ``serve/``, ``launch/``.  The port imports torch, numpy and
the standard library only.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
asking for CUDA on a host without it raises (``common.device``).  The
MoE hot path's four kernels (top-k gating, dispatch, combine, grouped
matmul) are hand-written CUDA C++ for Hopper under ``csrc/``, built with
nvcc at first use; each kernel module keeps a plain PyTorch version of
the same function, which its wrapper runs for CPU tensors only.
"""
