"""The port's hand-written CUDA kernels (``csrc/``), the build step, their
plain PyTorch versions and the device dispatch in :mod:`.ops`."""
