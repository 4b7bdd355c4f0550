"""The port's flash-attention wrapper (its plain version on the CPU) held
against the JAX package on the same numpy inputs: the Pallas kernel in
interpret mode (``repro.kernels.flash_attention.ops``, on the shapes of
tests/test_kernels.py) and the model's forward
(``repro.models.flash.flash_attention_padded``, incl. ragged lengths).

Tolerances: fp32 rtol = atol = 1e-5 (the same fp32 arithmetic, summed in
another order); bf16 3e-2 (tests/test_kernels.py's own: the JAX forward
rounds p to bf16 before P.V, the port keeps it in fp32)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.flash_attention.ops import flash_attention as pallas_flash  # noqa: E402
from repro.models import flash as j_flash                      # noqa: E402

from repro_torch.kernels import LAUNCHES, reset_launches       # noqa: E402
from repro_torch.kernels.flash_attention import ops            # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.models import flash as p_flash                # noqa: E402

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _qkv(seed, B, Sq, Skv, H, KH, Dh):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Sq, H, Dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, Dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, Dh)).astype(np.float32))


def _t(x, dtype=torch.float32):
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 32)])
@pytest.mark.parametrize("S,H,KH,Dh", [(128, 4, 2, 64), (128, 2, 2, 80),
                                       (256, 4, 1, 32)])
def test_wrapper_matches_pallas_kernel(causal, window, S, H, KH, Dh):
    q, k, v = _qkv(S + H + Dh, 2, S, S, H, KH, Dh)
    want = pallas_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, window=window, block_q=64, block_kv=64)
    reset_launches()
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    assert LAUNCHES["flash_attention"] == 0        # CPU tensors: plain version
    assert got.shape == (2, S, H, Dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)


def test_wrapper_matches_pallas_kernel_bf16():
    q, k, v = _qkv(7, 1, 128, 128, 2, 2, 64)
    bf = jnp.bfloat16
    want = pallas_flash(jnp.asarray(q, bf), jnp.asarray(k, bf), jnp.asarray(v, bf),
                        causal=True, block_q=64, block_kv=64)
    got = ops.flash_attention(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                              _t(v, torch.bfloat16), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **BF16)


def test_gqa_reads_kv_head_h_over_g():
    """Query head h reads kv head h // G: with KH = 2, G = 2, heads 0 and 1
    must attend kv head 0 (a map of h % KH would send head 1 to kv head 1)."""
    q, k, v = _qkv(3, 1, 16, 16, 4, 2, 8)
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    for h in range(4):
        one = attention_ref(_t(q)[:, :, h:h + 1], _t(k)[:, :, h // 2:h // 2 + 1],
                            _t(v)[:, :, h // 2:h // 2 + 1], causal=True)
        np.testing.assert_allclose(got[:, :, h:h + 1].numpy(), one.numpy(), **F32)


@pytest.mark.parametrize("S,causal,window", [(64, True, 0), (40, True, 0),
                                             (40, False, 0), (40, True, 12),
                                             (96, True, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_forward_matches_jax_flash(S, causal, window, dtype):
    """models/flash.py against the JAX forward at the smoke blocking (block_q
    16, block_kv 32): S = 40 is ragged for both, so JAX pads and the port
    masks its edge."""
    B, KH, G, Dh = 2, 2, 2, 16
    q, k, v = _qkv(S + window, B, S, S, KH * G, KH, Dh)
    q5 = q.reshape(B, S, KH, G, Dh)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    want = j_flash.flash_attention_padded(
        jnp.asarray(q5, jd), jnp.asarray(k, jd), jnp.asarray(v, jd), causal,
        window, 0, 16, 32, tri=False)
    got = p_flash.flash_attention_padded(_t(q5, td), _t(k, td), _t(v, td),
                                         causal, window)
    assert got.shape == (B, S, KH, G, Dh) and got.dtype == td
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def test_model_forward_has_no_backward_yet():
    """The model's flash call has had a backward since the training slice
    (the name is older): its grads equal autograd's through the plain
    version within the bf16 rounding the recompute backward applies to p,
    dout and ds (2e-2 of the largest grad; tests/test_torch_train_flash.py
    holds it to the JAX VJP at 1e-5)."""
    q, k, v = (_t(x).requires_grad_(True) for x in _qkv(0, 1, 8, 8, 2, 1, 8))
    out = p_flash.flash_attention_padded(q.reshape(1, 8, 1, 2, 8), k, v)
    out.sum().backward()
    q2, k2, v2 = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    attention_ref(q2, k2, v2).sum().backward()
    for a, b in ((q, q2), (k, k2), (v, v2)):
        gap = (a.grad - b.grad).abs().max() / b.grad.abs().max()
        assert torch.isfinite(a.grad).all() and gap < 2e-2, gap


def _views(case):
    """q, k, v (B 2, S 16, H 4, KH 2) on the CPU as ``case`` lays them out."""
    dh = {"dh64": 64, "dh256": 256, "dh16": 16, "dh80": 80}.get(case.split()[-1], 128)
    dtype = torch.float32 if case.startswith("fp32") else torch.bfloat16
    if case.startswith("fused"):        # one (B, S, H + 2 KH, Dh) projection
        qkv = torch.zeros((2, 16, 8, dh), dtype=dtype)
        return qkv[:, :, :4], qkv[:, :, 4:6], qkv[:, :, 6:]
    if case.startswith("offset"):       # base 2 elements past an aligned one
        n = 2 * 16 * 4 * dh
        buf = torch.zeros(2 + 2 * n, dtype=dtype)
        q = buf[2:2 + n].view(2, 16, 4, dh)
        return q, q[:, :, :2], q[:, :, 2:]
    if case.startswith("stride"):       # head stride Dh + 4: not a multiple of 8
        x = torch.zeros((2, 16, 4, dh + 4), dtype=dtype)[..., :dh]
        return x, x[:, :, :2], x[:, :, 2:]
    return (torch.zeros((2, 16, 4, dh), dtype=dtype),
            torch.zeros((2, 16, 2, dh), dtype=dtype),
            torch.zeros((2, 16, 2, dh), dtype=dtype))


@pytest.mark.parametrize("case,want", [
    ("bf16 contiguous dh64", "sm90"), ("bf16 contiguous dh128", "sm90"),
    ("bf16 contiguous dh256", "sm90"), ("fused bf16 dh64", "sm90"),
    ("fused bf16 dh128", "sm90"), ("fused bf16 dh256", "sm90"),
    ("fp32 contiguous dh128", "simt"), ("fp32 fused dh64", "simt"),
    ("bf16 contiguous dh16", "simt"), ("bf16 contiguous dh80", "simt"),
    ("offset bf16 dh128", "simt"), ("stride bf16 dh128", "simt"),
])
def test_routing_rule(case, want):
    """bf16 at Dh 64/128/256 with TMA-legal bases and strides goes to the
    Hopper kernel; fp32, other head dims and misaligned views to the simt
    kernel. Decided from the tensors alone, before any launch."""
    q, k, v = _views(case)
    assert ops._variant(q, k, v) == want
    reset_launches()
    ops.flash_attention(q, k, v)          # CPU: the plain version, whatever the rule
    assert sum(LAUNCHES.values()) == 0


@pytest.mark.parametrize("dh", [64, 128, 256])
def test_chip_smoke_simt_view_goes_to_simt(dh):
    """chip_smoke holds and times the simt kernel in bf16 on copies whose
    base lies 8 bytes past an aligned one: the routing rule sends them to
    the simt kernel at every head dim the sm90 kernel takes, and the values
    are the originals."""
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    qkv = _views(f"bf16 contiguous dh{dh}")
    qkv = tuple(x.normal_() for x in qkv)
    assert ops._variant(*qkv) == "sm90"
    views = tuple(chip_smoke._simt_view(torch, x) for x in qkv)
    assert ops._variant(*views) == "simt"
    for x, y in zip(qkv, views):
        assert y.data_ptr() % 16 == 8 and torch.equal(x, y)


def test_wrapper_rejects_mismatched_shapes():
    q, k, v = (_t(x) for x in _qkv(0, 1, 8, 8, 3, 2, 8))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v)                   # H % KH != 0
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :, :2], k, v[:, :4])  # v != k
    with pytest.raises(ValueError):
        ops.flash_attention(q[:, :, :2], k, v, window=-1)
