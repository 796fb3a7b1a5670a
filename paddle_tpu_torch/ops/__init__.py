"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version (the counterparts of ``paddle_tpu.ops.pallas``)."""
