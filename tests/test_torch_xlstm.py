"""The port's xLSTM blocks (``repro_torch.models.xlstm``) held against the
JAX package's ``repro.models.xlstm`` on the same params (JAX init, carried
across with ``repro_torch.convert``) and the same numpy inputs, in fp32:
the mLSTM chunkwise apply (S a chunk multiple and not: 16-token chunks at
S 40 pad with gate-neutral positions), with and without a carried state,
and its decode steps; the sLSTM sequential apply and its decode steps; the
grads of both blocks against ``jax.grad`` for fp32 and bf16 inputs (the
blocks compute in fp32 whatever the input dtype); and the port's own
counterpart of ``tests/test_models.py::test_xlstm_single_layer_decode_gap``.

Tolerances: rtol = atol = 1e-5 on outputs and states (measured worst
9.5e-7, the sLSTM n state); grads within 1e-5 relative L2 a leaf in fp32
and 1e-4 for bf16 inputs (measured 6.8e-7 and 7.2e-5: the bf16 rounding
of the input's grad)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import smoke_config as j_smoke_config        # noqa: E402
from repro.models import xlstm as j_x                           # noqa: E402

from repro_torch import convert, tree                           # noqa: E402
from repro_torch.configs import smoke_config                    # noqa: E402
from repro_torch.models import xlstm as p_x                     # noqa: E402

TOL = 1e-5
GRAD_TOL = {"float32": 1e-5, "bfloat16": 1e-4}
B = 2
BLOCKS = {"mlstm": (j_x.mlstm_init, j_x.mlstm_apply, j_x.mlstm_decode,
                    j_x.mlstm_state_init, p_x.mlstm_apply, p_x.mlstm_decode,
                    p_x.mlstm_state_init),
          "slstm": (j_x.slstm_init, j_x.slstm_apply, j_x.slstm_decode,
                    j_x.slstm_state_init, p_x.slstm_apply, p_x.slstm_decode,
                    p_x.slstm_state_init)}


def _cfgs():
    return j_smoke_config("xlstm-125m"), smoke_config("xlstm-125m")


def _x(cfg, S, seed):
    return (0.5 * np.random.RandomState(seed).standard_normal(
        (B, S, cfg.d_model))).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def _states_close(p_state, j_state):
    assert sorted(p_state) == sorted(j_state)
    for k in j_state:
        assert tuple(p_state[k].shape) == j_state[k].shape
        assert p_state[k].dtype == torch.float32
        _close(p_state[k], j_state[k])


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("S", [16, 40])
@pytest.mark.parametrize("carried", [False, True])
def test_apply_and_decode_match_jax(block, S, carried):
    """apply over S tokens (from a state that an earlier segment left, or
    none), then 4 decode steps; outputs and the states each leaves."""
    j_init, j_apply, j_decode, j_state, p_apply, p_decode, p_state = BLOCKS[block]
    jcfg, pcfg = _cfgs()
    assert jcfg.scan_chunk == pcfg.scan_chunk == 16
    params, _ = j_init(jax.random.PRNGKey(S), jcfg)
    pp = convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    x = _x(jcfg, S + 4 + 8, seed=S)
    if not carried:
        jy, none = j_apply(params, jcfg, jnp.asarray(x[:, :S]))
        py, pnone = p_apply(pp, pcfg, torch.from_numpy(x[:, :S]))
        assert none is None and pnone is None
        _close(py, jy)
        return
    # the state an 8-token earlier segment leaves
    jc = j_state(jcfg, B)
    _, jc = j_apply(params, jcfg, jnp.asarray(x[:, -8:]), cache=jc)
    pc = p_state(pcfg, B, "cpu")
    _, same = p_apply(pp, pcfg, torch.from_numpy(x[:, -8:]), cache=pc)
    assert same is pc                     # written in place
    _states_close(pc, jc)
    jy, jc = j_apply(params, jcfg, jnp.asarray(x[:, :S]), cache=jc)
    py, pc = p_apply(pp, pcfg, torch.from_numpy(x[:, :S]), cache=pc)
    _close(py, jy)
    _states_close(pc, jc)
    for t in range(S, S + 4):
        jy, jc = j_decode(params, jcfg, jnp.asarray(x[:, t:t + 1]), jc)
        py, pc = p_decode(pp, pcfg, torch.from_numpy(x[:, t:t + 1]), pc)
        assert py.shape == (B, 1, jcfg.d_model)
        _close(py, jy)
        _states_close(pc, jc)


def test_state_init_matches_jax():
    jcfg, pcfg = _cfgs()
    for block in ("mlstm", "slstm"):
        want = BLOCKS[block][3](jcfg, B)
        got = BLOCKS[block][6](pcfg, B, "cpu")
        for k in want:
            assert torch.equal(got[k], torch.tensor(np.asarray(want[k])))


@pytest.mark.parametrize("block", sorted(BLOCKS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grads_match_jax(block, dtype):
    """d(sum(y * ct)) / d(params, x) through the whole block (S 40: the
    mLSTM chunk padding and its stabilizer, the sLSTM loop)."""
    j_init, j_apply, _, _, p_apply, _, _ = BLOCKS[block]
    jcfg, pcfg = _cfgs()
    params, _ = j_init(jax.random.PRNGKey(1), jcfg)
    x = _x(jcfg, 40, seed=2)
    ct = np.random.RandomState(3).standard_normal(x.shape).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)

    def j_loss(p, x):
        return jnp.sum(j_apply(p, jcfg, x.astype(jd))[0].astype(jnp.float32) * ct)

    j_gp, j_gx = jax.grad(j_loss, argnums=(0, 1))(params, jnp.asarray(x))
    leaves = [t.requires_grad_() for t in tree.leaves(
        convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu"))]
    xt = torch.from_numpy(x).requires_grad_()
    y, _ = p_apply(tree.unflatten(params, leaves), pcfg, xt.to(td))
    (y.float() * torch.from_numpy(ct)).sum().backward()
    for got, want in zip([xt, *leaves], [j_gx, *jax.tree.leaves(j_gp)]):
        want = np.asarray(want)
        gap = np.linalg.norm(got.grad.numpy() - want) / np.linalg.norm(want)
        assert gap <= GRAD_TOL[dtype], (tuple(got.shape), gap)


def test_single_layer_decode_gap():
    """tests/test_models.py::test_xlstm_single_layer_decode_gap on the port:
    one fp32 mLSTM layer's chunkwise prefill and its decode step at the
    same position differ by well under the 0.06-a-layer budget, and the
    prefix (chunkwise both times) is bitwise."""
    _, cfg = _cfgs()
    Bx, Sx = 2, 64
    params, _ = j_x.mlstm_init(jax.random.PRNGKey(0), j_smoke_config("xlstm-125m"))
    p = convert.params_from_jax(jax.tree.map(np.asarray, params), "cpu")
    x = torch.from_numpy((0.5 * np.random.RandomState(1).standard_normal(
        (Bx, Sx + 1, cfg.d_model))).astype(np.float32))
    y_full, _ = p_x.mlstm_apply(p, cfg, x, cache=p_x.mlstm_state_init(cfg, Bx, "cpu"))
    cache = p_x.mlstm_state_init(cfg, Bx, "cpu")
    y_pre, cache = p_x.mlstm_apply(p, cfg, x[:, :Sx], cache=cache)
    y_last, _ = p_x.mlstm_decode(p, cfg, x[:, Sx:], cache)
    assert torch.equal(y_full[:, :Sx], y_pre)
    gap = float((y_full[:, -1] - y_last[:, 0]).abs().max())
    assert gap < 0.03, gap


def test_full_width_prefill_then_decode_gap_is_the_references():
    """xlstm-125m at its published config (12 layers, d 768), fp32: a
    prefill of P = 2048 tokens (128 whole mLSTM chunks) and token P decoded,
    against a prefill of P + 1 tokens, on the JAX package and the port
    from the same params (JAX init, key 4) and tokens. The port's two runs
    equal the reference's within 2.5e-3 of the logits' scale (measured
    6.1e-4), so the gap between them is the reference's own: at this draw
    of the weights it is far outside the smoke-size bound of
    tests/test_models.py (0.06 a layer: 0.72; mean < 0.18; argmax
    agreement > 0.95), which other draws meet. chip_smoke's phase 15b
    therefore holds the card's two runs to the CPU's on the same weights
    and only prints that bound. ~35 s and ~3 GB on an 8-core CPU."""
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as j_tf
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as p_tf

    jcfg, cfg = j_get_config("xlstm-125m"), get_config("xlstm-125m")
    P = 2048
    params = jax.tree.map(np.asarray, j_tf.init(jax.random.PRNGKey(4), jcfg)[0])
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (B, P + 1))

    def jax_prefill(S):
        cache = jax.tree.map(lambda x: x.astype(jnp.float32), j_tf.cache_init(jcfg, B, P + 8)[0])
        return jax.jit(lambda p, b, c: j_tf.prefill(p, jcfg, b, c, dtype=jnp.float32))(
            params, {"tokens": jnp.asarray(toks[:, :S])}, cache)

    j_dec = jax.jit(lambda p, c, t: j_tf.decode_step(
        p, jcfg, t, c, jnp.asarray(P, jnp.int32), dtype=jnp.float32))(
        params, jax_prefill(P)[1], jnp.asarray(toks[:, P:]))[0]
    j_full = jax_prefill(P + 1)[0]

    w = convert.params_from_jax(params, "cpu")
    _, cache = p_tf.prefill(w, cfg, {"tokens": torch.as_tensor(toks[:, :P])},
                            p_tf.cache_init(cfg, B, P + 8, "cpu"), dtype=torch.float32)
    p_dec, _ = p_tf.decode_step(w, cfg, torch.as_tensor(toks[:, P:]), cache, P,
                                dtype=torch.float32)
    p_full, _ = p_tf.prefill(w, cfg, {"tokens": torch.as_tensor(toks)},
                             p_tf.cache_init(cfg, B, P + 8, "cpu"), dtype=torch.float32)
    d, f = np.asarray(j_dec, np.float32), np.asarray(j_full, np.float32)
    scale = np.abs(f).max()
    for got, want in ((p_dec, d), (p_full, f)):
        assert np.abs(got.numpy() - want).max() <= 2.5e-3 * scale
    gap = np.abs(d - f)
    assert gap.max() > 0.06 * cfg.num_layers + 0.1 * np.abs(f).max()
    assert gap.mean() > 0.015 * cfg.num_layers
    assert (d.argmax(-1) == f.argmax(-1)).mean() <= 0.5
