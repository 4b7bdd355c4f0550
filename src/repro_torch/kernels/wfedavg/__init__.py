"""Fused Eq. 3 weighted FedAvg: CUDA kernel (``csrc/wfedavg.cu``), plain
PyTorch version (``ref``) and the tree-level wrapper (``ops``)."""
