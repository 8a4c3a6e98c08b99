from .native import native_available, native_cluster, native_preprocess, native_spmm_oracle

__all__ = ["native_available", "native_cluster", "native_preprocess", "native_spmm_oracle"]
