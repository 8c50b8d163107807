"""PyTorch/CUDA port of the ExpMul FlashAttention serving and training
stack.

The package mirrors ``repro``'s layout module for module, imports
``torch`` and never ``jax``, and runs its attention (serving ticks and
the training forward) on CUDA kernels written by hand for Hopper
(``csrc/``). Entry points default to
``device="cuda"``; pass ``device="cpu"`` to run the kernels' plain PyTorch
versions instead.
"""
