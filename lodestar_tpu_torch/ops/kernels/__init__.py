"""The hand-written CUDA kernels of the port (field.cuh, fused_kernels.cu)
and their nvcc build (_build.py); host_shim.cpp is their CPU test build."""
