"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(a CUDA kernel has no CPU or interpret mode; the CPU tests hold the plain
versions to the JAX package). Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(25, 6), (150, 16), (784, 120), (120, 84),
                                   (84, 10), (1, 120), (1001, 256), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pair_bitwise_vs_plain(cuda, shape, dtype):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    g = torch.Generator().manual_seed(shape[0] * shape[1])
    x = (torch.randn(shape, generator=g) * 3.0).to(cuda, getattr(torch, dtype))
    reset_launches()
    q, s = ops.quantize_rows(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(ops.dequantize_rows(q, s), dequantize_ref(q, s))
    torch.cuda.synchronize()
    assert LAUNCHES["quantize"] == 1 and LAUNCHES["dequantize"] == 1


@pytest.mark.parametrize("n,d,offset", [(10, 94080, 0), (10, 10080, 0),
                                        (10, 10081, 0), (3, 4100, 1)])
def test_wfedavg_kernel_vs_plain(cuda, n, d, offset):
    from repro_torch.kernels.wfedavg import ops
    from repro_torch.kernels.wfedavg.ref import wfedavg_ref
    g = torch.Generator().manual_seed(d)
    models = (torch.randn((n, d + offset), generator=g) * 0.05).to(cuda)[:, offset:]
    prev = (torch.randn((d + offset,), generator=g) * 0.05).to(cuda)[offset:]
    wn = torch.softmax(torch.randn((n,), generator=g), 0).to(cuda)
    out = ops.wfedavg_flat(models, wn, prev)
    torch.testing.assert_close(out, wfedavg_ref(models, wn, prev),
                               rtol=1e-6, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.wfedavg import ops as wf_ops
    with pytest.raises(ValueError):
        q_ops.quantize_rows(torch.zeros((4, 300), device=cuda))
    with pytest.raises(TypeError):
        q_ops.quantize_rows(torch.zeros((4, 8), device=cuda, dtype=torch.float16))
    with pytest.raises(TypeError):
        wf_ops.wfedavg_flat(torch.zeros((2, 8), device=cuda, dtype=torch.float64),
                            torch.ones(2, device=cuda), torch.zeros(8, device=cuda))
