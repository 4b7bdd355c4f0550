"""The port's MoE FFN (``repro_torch.models.moe``) held against the JAX
package's ``repro.models.moe`` on the same params (JAX init, carried across
with ``repro_torch.convert``) and the same numpy inputs, in fp32.

Checked: ``moe_apply`` per row (S 64) and flat (S 1, decode), with and
without a shared expert (smoke dbrx-132b: 4 experts top-2; smoke
llama4-maverick: 4 experts top-1 and a shared expert), output and aux; a
case at capacity_factor 1.0 where (token, choice) pairs drop, against an
oracle that walks each row's pairs in row-major (N, k) order and keeps a
pair while its expert has a free slot; the top-k against
``jax.lax.top_k`` on values with many planted ties, and a router with two
identical columns; the expert stacks rounded through bf16 in the fp32
forward, and only they.

Tolerance: rtol = atol = 1e-5 on outputs of magnitude ~1 (the same fp32
products summed in another order; measured worst 4.2e-7); routing
(experts, kept sets) exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import smoke_config as j_smoke_config        # noqa: E402
from repro.models import moe as j_moe                           # noqa: E402

from repro_torch import convert, tree                           # noqa: E402
from repro_torch.configs import smoke_config                    # noqa: E402
from repro_torch.models import moe as p_moe                     # noqa: E402

TOL = 1e-5
ARCHS = ("dbrx-132b", "llama4-maverick-400b-a17b")


def _cfgs(arch, **moe_kw):
    jcfg, pcfg = j_smoke_config(arch), smoke_config(arch)
    if moe_kw:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, **moe_kw))
        pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(pcfg.moe, **moe_kw))
    return jcfg, pcfg


def _params(cfg, seed=0):
    p, _ = j_moe.moe_init(jax.random.PRNGKey(seed), cfg)
    return jax.tree.map(np.array, p)          # writable copies


def _x(cfg, B, S, seed=1):
    return np.random.RandomState(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _both(np_params, jcfg, pcfg, x):
    jy, jaux = j_moe.moe_apply(jax.tree.map(jnp.asarray, np_params), jcfg, jnp.asarray(x))
    py, paux = p_moe.moe_apply(convert.params_from_jax(np_params, "cpu"), pcfg,
                               torch.from_numpy(x))
    return (py.numpy(), float(paux)), (np.asarray(jy), float(jaux))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("B,S", [(2, 64), (6, 1)])
def test_moe_apply_matches_jax(arch, B, S):
    jcfg, pcfg = _cfgs(arch)
    assert (pcfg.moe.shared_expert, pcfg.moe.top_k) == (
        {"dbrx-132b": (False, 2), "llama4-maverick-400b-a17b": (True, 1)}[arch])
    np_params = _params(jcfg)
    assert ("shared" in np_params) == pcfg.moe.shared_expert
    (py, paux), (jy, jaux) = _both(np_params, jcfg, pcfg, _x(jcfg, B, S))
    assert py.shape == (B, S, jcfg.d_model)
    np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(paux, jaux, rtol=TOL, atol=TOL)


def _oracle(p, cfg, x):
    """y (B, S, d) by walking every row's (token, choice) pairs in
    row-major order: a pair is kept while its expert has a free slot
    (``capacity`` a row), and a kept pair adds gate x the expert's SwiGLU
    output (bf16-rounded stacks, fp32 math). Returns (y, kept (B, S, k))."""
    m = cfg.moe
    B, S, d = x.shape
    cap = p_moe.capacity(cfg, S)
    gates, experts, _ = p_moe._route(p, cfg, x)
    w = {k: p[k].to(torch.bfloat16).to(torch.float32) for k in ("gate", "up", "down")}
    y = torch.zeros_like(x)
    kept = torch.zeros((B, S, m.top_k), dtype=torch.bool)
    for b in range(B):
        used = [0] * m.num_experts
        for t in range(S):
            for c in range(m.top_k):
                e = int(experts[b, t, c])
                if used[e] >= cap:
                    continue
                used[e] += 1
                kept[b, t, c] = True
                h = torch.nn.functional.silu(x[b, t] @ w["gate"][e]) * (x[b, t] @ w["up"][e])
                y[b, t] += gates[b, t, c] * (h @ w["down"][e])
    return y, kept


def test_capacity_drop_keeps_the_same_pairs():
    """capacity_factor 1.0 at S 64, 4 experts top-2: capacity 32 a row, and
    pairs beyond an expert's 32nd drop. The port matches JAX and the
    row-major oracle, and the drop is real (some pairs dropped, a token
    losing both choices gets exactly 0)."""
    jcfg, pcfg = _cfgs("dbrx-132b", capacity_factor=1.0)
    assert p_moe.capacity(pcfg, 64) == 32
    np_params = _params(jcfg, seed=2)
    x = _x(jcfg, 2, 64, seed=3)
    # tilt the router toward expert 0 so that it overflows in both rows
    np_params["router"]["w"][:, 0] += 0.5 * x.mean((0, 1)) / np.square(x.mean((0, 1))).sum()
    (py, _), (jy, _) = _both(np_params, jcfg, pcfg, x)
    np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)
    p = convert.params_from_jax(np_params, "cpu")
    want, kept = _oracle(p, pcfg, torch.from_numpy(x))
    np.testing.assert_allclose(py, want.numpy(), rtol=TOL, atol=TOL)
    assert 0 < int((~kept).sum()) < kept.numel()
    j_experts = np.asarray(j_moe._route(jax.tree.map(jnp.asarray, np_params), jcfg,
                                        jnp.asarray(x))[1])
    p_experts = p_moe._route(p, pcfg, torch.from_numpy(x))[1].numpy()
    assert np.array_equal(j_experts, p_experts)
    gone = ~kept.any(-1)
    assert bool(gone.any()) and not np.any(py[gone.numpy()])


def test_top_k_breaks_ties_as_jax_does():
    """Values drawn from 3 levels over 128 experts: every row is full of
    exact ties; the indices (and values) equal ``jax.lax.top_k``'s."""
    rng = np.random.RandomState(4)
    probs = rng.randint(0, 3, (64, 128)).astype(np.float32) / 4
    for k in (1, 2, 4, 8):
        jv, ji = jax.lax.top_k(jnp.asarray(probs), k)
        pv, pi = p_moe.top_k(torch.from_numpy(probs), k)
        assert np.array_equal(pi.numpy(), np.asarray(ji))
        assert np.array_equal(pv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("B,S", [(2, 64), (6, 1)])
def test_planted_router_tie(B, S):
    """Router columns 1 and 2 identical: every token's probabilities of
    experts 1 and 2 tie exactly, and each package sends the token to the
    same experts (the lower index first)."""
    jcfg, pcfg = _cfgs("dbrx-132b")
    np_params = _params(jcfg, seed=5)
    np_params["router"]["w"][:, 2] = np_params["router"]["w"][:, 1]
    x = _x(jcfg, B, S, seed=6)
    j_experts = np.asarray(j_moe._route(jax.tree.map(jnp.asarray, np_params), jcfg,
                                        jnp.asarray(x))[1])
    p_experts = p_moe._route(convert.params_from_jax(np_params, "cpu"), pcfg,
                             torch.from_numpy(x))[1].numpy()
    assert np.array_equal(p_experts, j_experts)
    both = (p_experts == 1).any(-1) & (p_experts == 2).any(-1)
    one = (p_experts == 1).any(-1) != (p_experts == 2).any(-1)
    assert not np.any((p_experts == 2).any(-1) & ~(p_experts == 1).any(-1))
    assert (both | one).any()           # the tie decided a choice somewhere
    (py, paux), (jy, jaux) = _both(np_params, jcfg, pcfg, x)
    np.testing.assert_allclose(py, jy, rtol=TOL, atol=TOL)


def _bf16_rounded(t):
    return t.to(torch.bfloat16).to(torch.float32)


def test_expert_stacks_are_rounded_through_bf16_in_fp32():
    """In an fp32 forward the expert stacks enter as their bf16 roundings
    (JAX's ``gather_expert_weights``): pre-rounded stacks give the same
    bits, and fp32 stacks used unrounded would not match JAX. The router
    and the shared expert are not rounded."""
    jcfg, pcfg = _cfgs("llama4-maverick-400b-a17b")
    np_params = _params(jcfg, seed=7)
    x = torch.from_numpy(_x(jcfg, 2, 64, seed=8))
    p = convert.params_from_jax(np_params, "cpu")
    y, _ = p_moe.moe_apply(p, pcfg, x)
    rounded = dict(p, **{k: _bf16_rounded(p[k]) for k in ("gate", "up", "down")})
    assert torch.equal(p_moe.moe_apply(rounded, pcfg, x)[0], y)
    jy, _ = j_moe.moe_apply(jax.tree.map(jnp.asarray, np_params), jcfg,
                            jnp.asarray(x.numpy()))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
    # skipping the rounding moves the output by far more than the tolerance
    unrounded = p_moe._dispatch_combine(p, pcfg, x, p_moe.capacity(pcfg, 64))[0]
    unrounded = unrounded + p_moe.L.mlp_apply(p["shared"], x)
    assert float((unrounded - y).abs().max()) > 10 * TOL
    # rounding the shared expert changes the output, rounding the router
    # the aux (top-1: the renormalized gate is 1 whatever the router)
    y_aux = p_moe.moe_apply(p, pcfg, x)[1]
    for key, what in (("shared", 0), ("router", 1)):
        other = dict(p, **{key: tree.map(_bf16_rounded, p[key])})
        out = p_moe.moe_apply(other, pcfg, x)[what]
        assert not torch.equal(out, (y, y_aux)[what]), key
