"""The training side of the port's attention held against the JAX package
on the same numpy inputs: the flash recompute backward
(``repro_torch.models.flash``) against ``jax.vjp`` of
``repro.models.flash.flash_attention_padded`` (causal and windowed, the
triangle-packed ``tri=True`` path and the rectangular one, ragged lengths,
bidirectional), the log-sum-exp that the forward saves, and
``attn_impl="naive"`` (the blocked scans, differentiated by autograd as JAX
AD differentiates them).

Tolerances, fp32: the backward's output and each gradient within 1e-5
relative L2 distance of JAX's, and each element within 1e-4 of the
gradient's largest magnitude. Both round p, dout and ds to bf16 before the
gradient products (fp32 sums); their fp32 inputs differ in the last bits
(sums in another order), so an entry of ds next to a bf16 rounding
boundary can round the other way: one bf16 step of one entry moved an
element of dq by 1.0e-5 of the largest magnitude in the windowed case
(measured), the others <= 3e-7. The lse within rtol/atol 1e-5; the naive
path's output and grads within 1e-5 of the largest magnitude."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import attention as j_attn                     # noqa: E402
from repro.models import flash as j_flash                        # noqa: E402

from repro_torch.kernels import LAUNCHES, reset_launches         # noqa: E402
from repro_torch.kernels.flash_attention import ops              # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    LSE_EMPTY, attention_ref, flash_backward)
from repro_torch.models import attention as p_attn               # noqa: E402
from repro_torch.models import flash as p_flash                  # noqa: E402

TOL = 1e-5
BF16_FLIP_TOL = 1e-4


def _inputs(seed, B, Sq, Skv, KH, G, Dh):
    rng = np.random.RandomState(seed)
    return (rng.standard_normal((B, Sq, KH, G, Dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, Dh)).astype(np.float32),
            rng.standard_normal((B, Skv, KH, Dh)).astype(np.float32),
            rng.standard_normal((B, Sq, KH, G, Dh)).astype(np.float32))


def _scaled_gap(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max() / np.abs(want).max())


def _port_vjp(fn, q, k, v, dout):
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = fn(tq, tk, tv)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()


# (B, S, KH, G, Dh, causal, window): S 64 on the JAX blocks of 16 and a
# ragged S 40 (JAX pads to 48 and masks the padded keys)
CASES = [(2, 64, 2, 2, 16, True, 0), (2, 64, 2, 2, 16, True, 24),
         (2, 40, 2, 2, 16, True, 0), (2, 40, 2, 2, 16, True, 24),
         (1, 64, 1, 4, 32, False, 0), (1, 40, 2, 1, 16, False, 0)]


@pytest.mark.parametrize("tri", [True, False])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "B{}S{}KH{}G{}Dh{}c{}w{}".format(*c))
def test_flash_backward_matches_jax_vjp(case, tri):
    B, S, KH, G, Dh, causal, window = case
    q, k, v, dout = _inputs(S + window + G, B, S, S, KH, G, Dh)
    out, vjp = jax.vjp(
        lambda q, k, v: j_flash.flash_attention_padded(q, k, v, causal, window, 0,
                                                       16, 16, tri),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (out, *vjp(jnp.asarray(dout)))
    got = _port_vjp(lambda q, k, v: p_flash.flash_attention_padded(q, k, v, causal,
                                                                   window),
                    q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert g.shape == np.shape(w)
        w = np.asarray(w)
        rel_l2 = float(np.linalg.norm(g - w) / np.linalg.norm(w))
        assert rel_l2 <= TOL, (name, rel_l2)
        assert _scaled_gap(g, w) <= BF16_FLIP_TOL, (name, _scaled_gap(g, w))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 9), (False, 0)])
def test_flash_backward_blocks_and_skipped_pairs(causal, window):
    """The backward's result does not depend on its blocking: blocks of 8
    queries and 4 to 16 keys (many pairs, those the mask empties skipped)
    against one block, and against autograd through the plain version
    within the bf16 rounding of p, dout and ds (2e-2)."""
    B, S, KH, G, Dh = 1, 37, 2, 2, 8
    q, k, v, dout = (torch.from_numpy(x.reshape(B, x.shape[1], -1, x.shape[-1]))
                     for x in _inputs(3, B, S, S, KH, G, Dh))
    out, lse = attention_ref(q, k, v, causal=causal, window=window, return_lse=True)
    one = flash_backward(q, k, v, out, lse, dout, causal=causal, window=window,
                         block_q=64, block_kv=64)
    tq, tk, tv = (x.clone().requires_grad_(True) for x in (q, k, v))
    attention_ref(tq, tk, tv, causal=causal, window=window).backward(dout)
    for bkv in (4, 16):
        many = flash_backward(q, k, v, out, lse, dout, causal=causal,
                              window=window, block_q=8, block_kv=bkv)
        for a, b in zip(many, one):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-6)
    for a, b in zip(one, (tq.grad, tk.grad, tv.grad)):
        assert _scaled_gap(a.numpy(), b.numpy()) < 2e-2


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0)])
def test_lse_matches_the_jax_forward(causal, window):
    B, S, KH, G, Dh = 2, 64, 2, 2, 16
    q, k, v, _ = _inputs(7, B, S, S, KH, G, Dh)
    _, want = j_flash._fwd_impl(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal, window, 0, 16, 16, 0, True)
    reset_launches()
    out, lse = ops.flash_attention(torch.from_numpy(q.reshape(B, S, KH * G, Dh)),
                                   torch.from_numpy(k), torch.from_numpy(v),
                                   causal=causal, window=window, return_lse=True)
    assert LAUNCHES["flash_attention"] == 0       # CPU tensors: plain version
    assert lse.shape == (B, KH * G, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want).reshape(B, KH * G, S),
                               rtol=TOL, atol=TOL)


def test_lse_of_a_row_without_kept_keys():
    """Query rows past Skv + window keep no key: lse LSE_EMPTY (the
    kernels' masked score), the other rows a finite log-sum-exp."""
    q, k, v, _ = _inputs(1, 1, 12, 4, 1, 1, 8)
    _, lse = attention_ref(torch.from_numpy(q.reshape(1, 12, 1, 8)),
                           torch.from_numpy(k), torch.from_numpy(v), causal=True,
                           window=3, return_lse=True)
    empty = np.arange(12) >= 4 + 3 - 1
    assert (lse[0, 0, empty] == LSE_EMPTY).all()
    assert torch.isfinite(lse[0, 0, ~empty]).all() and (lse[0, 0, ~empty] > -1e3).all()


@pytest.mark.parametrize("kind", ["global", "local", "enc"])
def test_naive_attention_matches_jax_blocked_scans(kind):
    B, S, KH, G, Dh = 2, 64, 2, 2, 16
    q, k, v, dout = _inputs(11, B, S, S, KH, G, Dh)
    if kind == "local":
        j_fn = lambda q, k, v: j_attn._blocked_local(q, k, v, window=24, q_offset=0,
                                                     block_q=16)
        p_fn = lambda q, k, v: p_attn._blocked_local(q, k, v, window=24, q_offset=0,
                                                     block_q=16)
    else:
        causal = kind == "global"
        j_fn = lambda q, k, v: j_attn._blocked_global(
            q, k, v, causal=causal, q_offset=0, block_q=16, block_kv=32)
        p_fn = lambda q, k, v: p_attn._blocked_global(
            q, k, v, causal=causal, q_offset=0, block_q=16, block_kv=32)
    out, vjp = jax.vjp(j_fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = (out, *vjp(jnp.asarray(dout)))
    got = _port_vjp(p_fn, q, k, v, dout)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _scaled_gap(g, w) <= TOL, (name, _scaled_gap(g, w))
    with pytest.raises(ValueError, match="multiple"):
        p_attn._blocked_local(*(torch.from_numpy(x) for x in (q, k, v)), window=24,
                              q_offset=0, block_q=24)
