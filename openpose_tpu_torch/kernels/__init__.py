"""CUDA C++ sources of the port's hand-written kernels and their lazy build."""
