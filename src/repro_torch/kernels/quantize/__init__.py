"""Row-wise int8 quantize / dequantize: CUDA kernel (``csrc/quantize.cu``),
plain PyTorch version (``ref``) and wrappers (``ops``)."""
