"""SpMV kernels (CUDA), their plain versions and the kernel build."""
