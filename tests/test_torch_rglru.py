"""The port's RG-LRU block (``repro_torch.models.rglru``) held against the
JAX package's ``repro.models.rglru`` on the same params (JAX init, with
the zero biases and the conv bias perturbed so that they count, carried
across with ``repro_torch.convert``) and the same numpy inputs, in fp32:
``rglru_apply`` without a cache and with a carried cache (state and conv
taps from an earlier segment), ``rglru_decode`` steps, and the cache each
leaves. The port's parallel scan against a sequential loop (the oracle,
here only) and against ``jax.lax.associative_scan``; softplus and gelu at
their edges.

Tolerance: rtol = atol = 1e-5 (outputs and states of magnitude ~1; the
scan adds in another order than ``associative_scan``; measured worst
9.5e-7)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import smoke_config as j_smoke_config        # noqa: E402
from repro.models import rglru as j_rglru                       # noqa: E402

from repro_torch import convert                                 # noqa: E402
from repro_torch.configs import smoke_config                    # noqa: E402
from repro_torch.models import rglru as p_rglru                 # noqa: E402

TOL = 1e-5
B = 2


def _setup(seed=0):
    jcfg, pcfg = j_smoke_config("recurrentgemma-2b"), smoke_config("recurrentgemma-2b")
    p, _ = j_rglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.RandomState(seed)
    np_params = {k: (np.array(v) if not isinstance(v, dict) else
                     {kk: np.array(vv) for kk, vv in v.items()}) for k, v in p.items()}
    for k in ("b_r", "b_i", "conv_b"):
        np_params[k] = (0.1 * rng.standard_normal(np_params[k].shape)).astype(np.float32)
    for k in ("w_r", "w_i"):      # gates that vary with the input
        np_params[k] *= 20.0
    return jcfg, pcfg, np_params


def _x(cfg, S, seed):
    return np.random.RandomState(seed).standard_normal((B, S, cfg.d_model)).astype(np.float32)


def _cache(cfg, seed):
    rng = np.random.RandomState(seed)
    return {"h": rng.standard_normal((B, cfg.d_model)).astype(np.float32),
            "conv": rng.standard_normal((B, 3, cfg.d_model)).astype(np.float32)}


def _p_cache(np_cache):
    return {k: torch.from_numpy(v.copy()) for k, v in np_cache.items()}


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("S", [1, 7, 64, 100])
def test_apply_without_cache_matches_jax(S):
    jcfg, pcfg, np_params = _setup()
    x = _x(jcfg, S, seed=S)
    jy, _ = j_rglru.rglru_apply(jax.tree.map(jnp.asarray, np_params), jcfg,
                                jnp.asarray(x))
    py, none = p_rglru.rglru_apply(convert.params_from_jax(np_params, "cpu"), pcfg,
                                   torch.from_numpy(x))
    assert none is None
    _close(py, jy)


@pytest.mark.parametrize("S", [2, 64])
def test_apply_with_carried_cache_and_decode_match_jax(S):
    """A prefill that continues a carried state (h and three conv taps from
    an earlier segment), then 6 decode steps; outputs and caches."""
    jcfg, pcfg, np_params = _setup(seed=1)
    jp, pp = jax.tree.map(jnp.asarray, np_params), convert.params_from_jax(np_params, "cpu")
    x = _x(jcfg, S + 6, seed=10 + S)
    np_cache = _cache(jcfg, seed=S)
    jy, jc = j_rglru.rglru_apply(jp, jcfg, jnp.asarray(x[:, :S]),
                                 cache=jax.tree.map(jnp.asarray, np_cache))
    pc = _p_cache(np_cache)
    py, same = p_rglru.rglru_apply(pp, pcfg, torch.from_numpy(x[:, :S]), cache=pc)
    assert same is pc                     # written in place
    _close(py, jy)
    for k in ("h", "conv"):
        _close(pc[k], jc[k])
    for t in range(S, S + 6):
        jy, jc = j_rglru.rglru_decode(jp, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        py, pc = p_rglru.rglru_decode(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), pc)
        _close(py, jy)
        for k in ("h", "conv"):
            _close(pc[k], jc[k])


def test_bf16_cache_conv_taps_stay_bf16():
    """The conv taps live in the cache's dtype (bf16 by default), the
    state in fp32, as the JAX cache does."""
    jcfg, pcfg, np_params = _setup()
    jc = j_rglru.rglru_cache_init(jcfg, B)
    pc = p_rglru.rglru_cache_init(pcfg, B, "cpu")
    for k in ("h", "conv"):
        assert tuple(pc[k].shape) == jc[k].shape and str(pc[k].dtype)[6:] == str(jc[k].dtype)
    x = torch.from_numpy(_x(jcfg, 5, seed=3)).to(torch.bfloat16)
    y, pc = p_rglru.rglru_apply(convert.params_from_jax(np_params, "cpu"), pcfg, x,
                                cache=pc)
    assert y.dtype == torch.bfloat16 and pc["conv"].dtype == torch.bfloat16
    assert pc["h"].dtype == torch.float32


def _sequential(log_a, b):
    h = torch.zeros_like(b[:, 0])
    out = []
    for t in range(b.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("S", [1, 2, 3, 16, 33, 257])
def test_parallel_scan_is_the_recurrence(S):
    """The doubling scan against the step-by-step recurrence and against
    ``jax.lax.associative_scan`` with the JAX module's combine."""
    rng = np.random.RandomState(S)
    log_a = -np.abs(rng.standard_normal((B, S, 24))).astype(np.float32)
    b = rng.standard_normal((B, S, 24)).astype(np.float32)
    got = p_rglru.scan(torch.from_numpy(log_a), torch.from_numpy(b))
    _close(got, _sequential(torch.from_numpy(log_a), torch.from_numpy(b)))

    def combine(c1, c2):
        return c1[0] + c2[0], jnp.exp(c2[0]) * c1[1] + c2[1]

    _, want = jax.lax.associative_scan(combine, (jnp.asarray(log_a), jnp.asarray(b)),
                                       axis=1)
    _close(got, want)


def test_softplus_and_gelu_take_the_jax_forms():
    """softplus = logaddexp(x, 0) across torch's threshold of 20 (Lambda
    up to 40; the init draws it from [2, 6]), and the gate's gelu is the
    tanh approximation (``jax.nn.gelu``)."""
    jcfg, pcfg, np_params = _setup()
    np_params["lam"] = np.linspace(0.5, 40.0, jcfg.d_model).astype(np.float32)
    x = _x(jcfg, 1, seed=5)[:, 0]
    jl, jb = j_rglru._gates(jax.tree.map(jnp.asarray, np_params), jnp.asarray(x))
    pl, pb = p_rglru._gates(convert.params_from_jax(np_params, "cpu"), torch.from_numpy(x))
    _close(pl, jl)
    _close(pb, jb)
    v = np.linspace(-6, 6, 101).astype(np.float32)
    _close(torch.nn.functional.gelu(torch.from_numpy(v), approximate="tanh"),
           jax.nn.gelu(jnp.asarray(v)))
