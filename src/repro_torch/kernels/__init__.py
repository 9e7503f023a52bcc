"""The port's kernels: hand-written CUDA C++ for Hopper (``csrc/``), their
plain PyTorch versions (``ref``) and the per-site dispatch (``ops``)."""
