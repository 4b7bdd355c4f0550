"""Flash-attention forward: CUDA kernel (``csrc/flash_attention.cu``), plain
PyTorch version (``ref``) and wrapper (``ops``)."""
