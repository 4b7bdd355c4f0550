"""Block-wise int8 quantize / dequantize: one CUDA kernel pair
(``csrc/quantize.cu``) driven by a segment table (``table``), one launch a
direction for a whole parameter tree or for (R, C) rows; plain PyTorch
versions (``ref``) and wrappers (``ops``)."""
