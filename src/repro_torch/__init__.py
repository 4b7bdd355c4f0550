"""PyTorch/CUDA port of the DFL reproduction (`src/repro/` is the JAX
reference). Same subpackage layout and names; params are plain dicts of
tensors (`repro_torch.tree`), randomness comes from explicit
``torch.Generator``s, and every entry point takes an explicit ``device``
that defaults to ``"cuda"``. On CUDA tensors the int8 wire quantizer, the
Eq. 3 FedAvg and the LMs' prompt attention (flash attention) run through
the hand-written kernels in ``csrc/``; on CPU tensors they take the plain
PyTorch versions beside them.
"""
