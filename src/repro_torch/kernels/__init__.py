"""Low-rank kernels: CUDA (lowrank.py, csrc/lowrank.cu), plain versions (ref.py), device dispatch (ops.py)."""
