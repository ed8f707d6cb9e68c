"""PyTorch/CUDA port of the PowerSGD reproduction (``repro``).

Mirrors the JAX package's layout (``core/``, ``kernels/``, ``models/``,
``configs/``, ``optim/``, ``launch/``, ``data/``).  The low-rank products
of the power iteration run as hand-written CUDA kernels for Hopper on CUDA
tensors and as plain PyTorch on CPU tensors.
"""
