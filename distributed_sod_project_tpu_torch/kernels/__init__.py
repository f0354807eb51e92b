"""Hand-written Hopper kernels and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain version and its launch
counter.  A wrapper runs the plain version only for tensors on the CPU;
for CUDA tensors it launches the kernel or raises.
"""
