"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain version."""
