"""Project constants and environment-variable flag names for the
PyTorch/CUDA port (counterpart of voltrix_spmm_tpu/project/const.py).
"""

# Environment variables (all optional):
#   VOLTRIX_TORCH_NVCC                : override the nvcc used to build the kernels
#   VOLTRIX_TORCH_BUILD_DIR           : override the kernel build directory
#                                       (default: build/kernels at the repository root)
#   VOLTRIX_TORCH_PRINT_NVCC_COMMAND  : "1" -> print the nvcc and g++ command lines and
#                                       their output (ptxas registers, shared
#                                       memory, spills)
#   VOLTRIX_TORCH_CXX                 : override the host C++ compiler of the native
#                                       preprocess (default: g++ on PATH)
#   VOLTRIX_TORCH_DISABLE_NATIVE      : "1" -> csr_preprocess(backend="auto") takes
#                                       the numpy path
#   VOLTRIX_TORCH_CACHE_DIR           : override the tuner's disk cache directory
#                                       (default: ~/.voltrix_spmm_tpu_torch/cache)
#   VOLTRIX_TORCH_PRINT_AUTO_TUNE     : "1" -> print the tuner's candidates, times
#                                       and cache hits
#   VOLTRIX_TORCH_TUNE_BUDGET_S       : soft tuning time budget in seconds
#   VOLTRIX_TORCH_DEVICE_MEM_GB       : device memory (GB) the tuner may plan a
#                                       candidate's residency against (default: 80%
#                                       of the card's free memory)
NVCC_FLAG = "VOLTRIX_TORCH_NVCC"
BUILD_DIR_FLAG = "VOLTRIX_TORCH_BUILD_DIR"
PRINT_NVCC_COMMAND_FLAG = "VOLTRIX_TORCH_PRINT_NVCC_COMMAND"
CXX_FLAG = "VOLTRIX_TORCH_CXX"
DISABLE_NATIVE_FLAG = "VOLTRIX_TORCH_DISABLE_NATIVE"
CACHE_DIR_FLAG = "VOLTRIX_TORCH_CACHE_DIR"
PRINT_AUTOTUNE_FLAG = "VOLTRIX_TORCH_PRINT_AUTO_TUNE"
TUNE_BUDGET_FLAG = "VOLTRIX_TORCH_TUNE_BUDGET_S"
DEVICE_MEM_FLAG = "VOLTRIX_TORCH_DEVICE_MEM_GB"
