"""Project constants and environment-variable flag names for the
PyTorch/CUDA port (counterpart of voltrix_spmm_tpu/project/const.py).
"""

# Environment variables (all optional):
#   VOLTRIX_TORCH_NVCC                : override the nvcc used to build the kernels
#   VOLTRIX_TORCH_BUILD_DIR           : override the kernel build directory
#                                       (default: build/kernels at the repository root)
#   VOLTRIX_TORCH_PRINT_NVCC_COMMAND  : "1" -> print nvcc command lines and output
#                                       (ptxas registers, shared memory, spills)
NVCC_FLAG = "VOLTRIX_TORCH_NVCC"
BUILD_DIR_FLAG = "VOLTRIX_TORCH_BUILD_DIR"
PRINT_NVCC_COMMAND_FLAG = "VOLTRIX_TORCH_PRINT_NVCC_COMMAND"
