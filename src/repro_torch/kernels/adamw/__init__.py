"""The train step's clip and AdamW: CUDA kernels (``csrc/adamw.cu``),
plain PyTorch version (``ref``) and wrappers (``ops``)."""
