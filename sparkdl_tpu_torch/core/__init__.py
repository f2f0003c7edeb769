"""Core: model functions, batching, the executor and the CUDA kernels."""
