"""The rest of the LM zoo in the port held against the JAX package's
``repro.models.transformer`` at ``smoke_config`` size: recurrentgemma-2b
(RG-LRU + local attention, and a depth with a trailing partial unit),
chatglm3-6b (partial rope, biases, GQA 2), command-r-35b (layernorm, tied
embeddings), dbrx-132b and llama4-maverick (MoE, the latter interleaved
with a shared expert), xlstm-125m (mLSTM + sLSTM), hubert-xlarge (the audio
frontend, encoder only) and llava-next (the vision frontend), on the same
params (JAX init, norm scales perturbed with numpy, carried across with
``repro_torch.convert``) and the same numpy inputs.

Checked: prefill logits of a ragged prompt (40 tokens: past recurrentgemma's
32 window, not a multiple of mLSTM's 16 chunk), 8 decode steps and the
caches they leave, in fp32 and bf16 (hubert: the encoder forward, and a
decode step that raises on both sides); ``train_loss`` (loss, accuracy,
aux) and its grads against ``jax.value_and_grad``; prefill-then-decode
consistency on the port alone (``tests/test_models.py``'s check and
tolerances); the full configs' param counts against the JAX test's ranges
and the JAX abstract init; the convert round trip; the leaf-by-leaf bf16
init.

Tolerances are ``tests/test_torch_transformer.py``'s where they hold:
fp32 (activations and caches fp32 on both sides) logits within rtol =
atol = 1e-4 and every argmax equal, KV caches and conv taps within 1e-5;
bf16 (the JAX default caches: bf16 keys, values and conv taps, fp32
recurrent states) the largest gap within 5e-2 of the largest magnitude,
of the logits and of each cache leaf, the JAX tokens fed to both sides.
Where a module needs its own, measured on this CPU:

- recurrent states (RG-LRU h, mLSTM C / n / m, sLSTM c / n / h / m) in
  fp32 within 1e-4: 48 steps of recurrence summed in another order
  (measured worst 1.14e-5, an sLSTM state);
- the bf16 argmax: random smoke-size logits are nearly flat (256 of them,
  the largest ~3), so the argmax flips wherever two logits lie within the
  bf16 gap (recurrentgemma 2 rows of 18, xlstm 1); a flip is allowed only
  where JAX's logits of the two tokens are within the bf16 bound of each
  other, in place of ``test_torch_transformer.py``'s 90% count;
- xLSTM in bf16 within 2e-2 of the scale a layer (0.16 for 8 layers): its
  fp32 recurrence amplifies the bf16 rounding of each block's input, ~0.5%
  a layer (``tests/test_models.py``'s note); measured worst 0.105;
- MoE in bf16: the router's top-k is discontinuous, and a bf16 rounding
  difference in a router input at a near tie sends a token to another
  expert (dbrx: two of 18 router calls, JAX probabilities 0.2009 / 0.2009
  and 0.2536 / 0.2566; that decode step's logits then differ by 0.41 of
  the scale). The test records both packages' routing: every difference
  must be a near tie (the JAX probabilities of the swapped experts within
  2e-2), and a step with one is exempt from the logit bound; in fp32 the
  routing must be identical.

``train_loss`` computes in bf16 activations on both sides:
``tests/test_torch_train_step.py``'s loss bound (5e-3) and its 6e-2
relative L2 a grad leaf; the MoE aux within 5e-3 relative (bf16 router
logits; measured 9.7e-4 on dbrx). xLSTM's bf16 train-loss grads are
ill-conditioned (the stabilized q·n denominator): JAX's own move 1.36
relative L2 a leaf when the params are scaled by 1 + 1e-3 noise (llama3's
0.022), so its bf16 grads are not compared; the grads of every new arch
are held instead through the whole stack in fp32 activations
(``test_fp32_stack_grads_match_jax``), and the xLSTM blocks' own in
``tests/test_torch_xlstm.py``."""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_get_config            # noqa: E402
from repro.configs import smoke_config as j_smoke_config        # noqa: E402
from repro.models import layers as j_L                          # noqa: E402
from repro.models import moe as j_moe                           # noqa: E402
from repro.models import transformer as j_tf                    # noqa: E402
from repro.train import step as j_step                          # noqa: E402

from repro_torch import convert, serve, tree                    # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import jax_fields  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches       # noqa: E402
from repro_torch.models import layers as p_L                    # noqa: E402
from repro_torch.models import moe as p_moe                     # noqa: E402
from repro_torch.models import transformer as p_tf              # noqa: E402
from repro_torch.train import step as p_step                    # noqa: E402

NEW_ARCHS = ("recurrentgemma-2b", "chatglm3-6b", "command-r-35b", "dbrx-132b",
             "llama4-maverick-400b-a17b", "xlstm-125m", "hubert-xlarge",
             "llava-next-mistral-7b")
B, P, GEN = 2, 40, 8
F32_TOL = {"logits": 1e-4, "cache": 1e-5, "state": 1e-4}
BF16_SCALE_TOL, XLSTM_BF16_PER_LAYER = 5e-2, 2e-2
ROUTE_TIE = 2e-2
LOSS_TOL, AUX_RTOL, GRAD_TOL = 5e-3, 5e-3, 6e-2
STATE_KEYS = ("h", "C", "n", "m", "c")      # recurrent states, fp32 always
# tests/test_models.py: bf16 prefill-then-decode within 0.08; xLSTM in fp32
# with 0.06 a layer (its chunkwise prefill and step decode differ ~0.5% a
# layer, compounding through the residual stream)
CONSISTENCY_TOL, XLSTM_PER_LAYER = 0.08, 0.06
# recurrentgemma cut to 4 layers: one (rglru, rglru, local) unit and a
# trailing rglru layer in params["rest"], as the full 26 = 8 x 3 + 2 has
CASES = [(a, None) for a in NEW_ARCHS] + [("recurrentgemma-2b", 4)]


def _cfgs(arch, layers=None):
    jcfg, pcfg = j_smoke_config(arch), smoke_config(arch)
    if layers is not None:
        jcfg = dataclasses.replace(jcfg, num_layers=layers)
        pcfg = dataclasses.replace(pcfg, num_layers=layers)
    return jcfg, pcfg


def _bf16_bound(cfg):
    if cfg.family == "ssm":
        return XLSTM_BF16_PER_LAYER * cfg.num_layers
    return BF16_SCALE_TOL


def _close(got, want, dtype, what, bound=BF16_SCALE_TOL):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL[what], atol=F32_TOL[what])
    else:
        gap, scale = np.abs(got - want).max(), np.abs(want).max()
        assert gap <= bound * scale, (what, gap, scale)


def _check_logits(got, want, dtype, bound):
    """One step's logits (B, V): within the tolerance; in bf16 every row
    whose argmax differs is a near tie (JAX's logits of the two tokens
    within the bound). In fp32 every argmax is equal."""
    _close(got, want, dtype, "logits", bound)
    flips = got.argmax(-1) != want.argmax(-1)
    if dtype == "float32":
        assert not flips.any()
    margin = want.max(-1) - want[np.arange(len(want)), got.argmax(-1)]
    assert (margin <= bound * np.abs(want).max()).all(), margin


_PARAMS = {}


def _params(arch, layers=None):
    """JAX-initialised params (PRNGKey 0) as numpy, norm scales perturbed."""
    if (arch, layers) not in _PARAMS:
        cfg = _cfgs(arch, layers)[0]
        params, _ = j_tf.init(jax.random.PRNGKey(0), cfg)
        rng = np.random.RandomState(0)

        def leaf(path, x):
            x = np.asarray(x)
            if "scale" in jax.tree_util.keystr(path):
                x = (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)
            return x

        _PARAMS[arch, layers] = jax.tree_util.tree_map_with_path(leaf, params)
    return _PARAMS[arch, layers]


def _inputs(cfg, S, seed):
    """numpy model inputs: tokens, or frame embeddings for the audio
    frontend; patch embeddings for the vision one."""
    rng = np.random.RandomState(seed)
    if cfg.frontend == "audio":
        return {"frame_embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)}
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["patch_embeds"] = (0.1 * rng.standard_normal(
            (B, cfg.num_patch_tokens, cfg.d_model))).astype(np.float32)
    return batch


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _p(batch, device="cpu"):
    return {k: torch.as_tensor(v, device=device).long() if k in ("tokens", "labels")
            else torch.as_tensor(v, device=device) for k, v in batch.items()}


_J_PREFILL = jax.jit(j_tf.prefill, static_argnums=(1, 4))
_J_DECODE = jax.jit(j_tf.decode_step, static_argnums=(1, 5))


def _jax_cache(cfg, dtype):
    cache, _ = j_tf.cache_init(cfg, B, P + GEN + 1)
    if dtype == jnp.float32:   # fp32 keys, values and conv taps
        cache = jax.tree.map(lambda x: x.astype(jnp.float32), cache)
    return cache


@contextlib.contextmanager
def _routes(monkeypatch):
    """Records every router call of both packages while the body runs:
    {"jax": [(experts, probs)], "port": [experts]} (numpy, in call order;
    JAX's through an ordered debug callback from inside its scans)."""
    rec = {"jax": [], "port": []}
    j_route, p_route = j_moe._route, p_moe._route

    def j_recorded(p, cfg, x):
        gates, experts, aux = j_route(p, cfg, x)
        probs = jax.nn.softmax(j_L.dense_apply(p["router"], x).astype(jnp.float32), -1)
        jax.debug.callback(lambda e, q: rec["jax"].append((np.asarray(e), np.asarray(q))),
                           experts, probs, ordered=True)
        return gates, experts, aux

    def p_recorded(p, cfg, x):
        gates, experts, aux = p_route(p, cfg, x)
        rec["port"].append(experts.numpy())
        return gates, experts, aux

    monkeypatch.setattr(j_moe, "_route", j_recorded)
    monkeypatch.setattr(p_moe, "_route", p_recorded)
    yield rec


def _route_flips(rec, dtype, position):
    """The (row, position) of each token whose router calls chose other
    experts in the two packages in one step (``position``: where the
    step's tokens sit, None for a prompt); each must be a near tie, and in
    fp32 there must be none."""
    assert len(rec["jax"]) == len(rec["port"]) > 0
    flips = set()
    for (je, jp), pe in zip(rec["jax"], rec["port"]):
        diff = (np.sort(je, -1) != np.sort(pe, -1)).any(-1)
        assert dtype == "bfloat16" or not diff.any(), "fp32 routing differs"
        for ix in zip(*np.nonzero(diff)):
            gap = np.take(jp[ix], je[ix]).min() - np.take(jp[ix], pe[ix]).min()
            assert abs(gap) <= ROUTE_TIE, (ix, je[ix], pe[ix], jp[ix])
            # a prompt row is (row, token); a decode step is one flat row
            flips.add(ix if position is None else (ix[1], position))
    rec["jax"].clear()
    rec["port"].clear()
    return flips


@pytest.mark.parametrize("arch,layers", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, layers, dtype, monkeypatch):
    jcfg, pcfg = _cfgs(arch, layers)
    assert jax_fields(pcfg) == dataclasses.asdict(jcfg)   # copied configs
    np_params = _params(arch, layers)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    bound = _bf16_bound(jcfg)
    batch = _inputs(jcfg, P, seed=P)
    j_params = jax.tree.map(jnp.asarray, np_params)
    p_params = convert.params_from_jax(np_params, "cpu")
    if not jcfg.supports_decode:      # hubert: the encoder forward only
        j_logits, _ = _J_PREFILL(j_params, jcfg, _j(batch), None, jd)
        p_logits, _ = p_tf.prefill(p_params, pcfg, _p(batch), None, dtype=td)
        _check_logits(p_logits.numpy(), np.asarray(j_logits), dtype, bound)
        tok = np.zeros((B, 1), np.int32)
        with pytest.raises(ValueError, match="encoder-only"):
            j_tf.decode_step(j_params, jcfg, jnp.asarray(tok), None, 0)
        with pytest.raises(ValueError, match="encoder-only"):
            p_tf.decode_step(p_params, pcfg, torch.as_tensor(tok), None, 0)
        return

    moe = jcfg.moe is not None
    routes = _routes(monkeypatch) if moe else contextlib.nullcontext()
    # the MoE archs run the JAX side eagerly, so the recorder is traced
    j_prefill, j_decode = ((j_tf.prefill, j_tf.decode_step) if moe
                           else (_J_PREFILL, _J_DECODE))
    with routes as rec:
        j_cache = _jax_cache(jcfg, jd)
        j_logits, j_cache = j_prefill(j_params, jcfg, _j(batch), j_cache, jd)
        p_cache = p_tf.cache_init(pcfg, B, P + GEN + 1, "cpu", dtype=td)
        reset_launches()
        p_logits, p_cache = p_tf.prefill(p_params, pcfg, _p(batch), p_cache, dtype=td)
        assert sum(LAUNCHES.values()) == 0            # CPU: the plain versions
        assert p_logits.dtype == torch.float32 and p_logits.shape == (B, jcfg.vocab_size)
        flips = _route_flips(rec, dtype, None) if moe else set()
        if not flips:
            _check_logits(p_logits.numpy(), np.asarray(j_logits), dtype, bound)
        j_tok = jnp.argmax(j_logits, -1)[:, None]
        for i in range(GEN):
            p_tok = torch.from_numpy(np.array(j_tok)).long()
            j_logits, j_cache = j_decode(j_params, jcfg, j_tok, j_cache,
                                         jnp.asarray(P + i, jnp.int32), jd)
            p_logits, p_cache = p_tf.decode_step(p_params, pcfg, p_tok, p_cache, P + i,
                                                 dtype=td)
            step_flips = _route_flips(rec, dtype, P + i) if moe else set()
            if not step_flips:
                _check_logits(p_logits.numpy(), np.asarray(j_logits), dtype, bound)
            flips |= step_flips
            j_tok = jnp.argmax(j_logits, -1)[:, None]
    # the caches left behind: same layout and dtypes, same values (but at
    # the positions of tokens the two routers sent to other experts)
    for part in ("units", "rest"):
        assert (p_cache[part] is None) == (j_cache[part] is None)
        if p_cache[part] is None:
            continue
        for pe, je in zip(p_cache[part], j_cache[part]):
            assert sorted(pe) == sorted(je)
            for key in sorted(pe):
                got, want = pe[key], je[key]
                assert tuple(got.shape) == want.shape
                assert str(got.dtype)[6:] == str(want.dtype)
                what = "state" if key in STATE_KEYS else "cache"
                got, want = convert.params_to_numpy(got), np.asarray(want, np.float32)
                for b, pos in flips:          # (..., B, L, KH, Dh) attention caches
                    got[..., b, pos, :, :] = want[..., b, pos, :, :]
                _close(got, want, dtype, what, bound)


def _train_batch(cfg, S=64):
    batch = _inputs(cfg, S, seed=7)
    rng = np.random.RandomState(8)
    batch["labels"] = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int32)
    if cfg.frontend == "audio":
        batch["loss_mask"] = (rng.uniform(size=(B, S)) < 0.5).astype(np.float32)
    return batch


def _grads_close(got_tree, want_tree, tol):
    """Each grad leaf within ``tol`` relative L2 of max(its JAX norm, 1e-2
    of the largest leaf's): a leaf whose grad is zero in exact arithmetic
    (an attention key bias: softmax is shift invariant) holds only
    rounding noise on both sides (hubert: 5e-5 against 0.72 for the
    largest leaf). A leaf the loss does not use has zero grads."""
    got = tree.leaves(convert.params_to_numpy(got_tree))
    want = [np.asarray(x) for x in jax.tree.leaves(want_tree)]
    assert [g.shape for g in got] == [w.shape for w in want]
    floor = 1e-2 * max(np.linalg.norm(w) for w in want)
    gaps = []
    for g, w in zip(got, want):
        if not np.any(w):   # hubert's token table: frame embeddings in its place
            assert not np.any(g)
        gaps.append(np.linalg.norm(g - w) / max(np.linalg.norm(w), floor))
    assert max(gaps) <= tol, max(gaps)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_loss_and_grads_match_jax(arch):
    jcfg, pcfg = _cfgs(arch)
    np_params = _params(arch)
    batch = _train_batch(jcfg)

    def j_loss(params):
        return j_tf.train_loss(params, jcfg, _j(batch))

    (j_val, j_met), j_grads = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        jax.tree.map(jnp.asarray, np_params))
    p_val, p_met, p_grads = p_step.loss_and_grads(
        convert.params_from_jax(np_params, "cpu"), pcfg, _p(batch))
    assert abs(float(p_val) - float(j_val)) <= LOSS_TOL
    assert abs(float(p_met["loss"]) - float(j_met["loss"])) <= LOSS_TOL
    assert abs(float(p_met["accuracy"]) - float(j_met["accuracy"])) <= 2 / (B * 64)
    assert abs(float(p_met["aux"]) - float(j_met["aux"])) <= AUX_RTOL * float(j_met["aux"])
    assert (float(p_met["aux"]) > 0) == (jcfg.moe is not None)
    if jcfg.family != "ssm":          # xLSTM: see the module docstring
        _grads_close(p_grads, j_grads, GRAD_TOL)
    assert all(bool(torch.isfinite(g).all()) for g in tree.leaves(p_grads))


def _j_fp32_loss(params, cfg, batch):
    h, positions = j_tf._embed_inputs(params, cfg, batch, dtype=jnp.float32)
    h, _, aux = j_tf._stack_forward(params, cfg, h, positions, cache=None)
    logits = j_tf._unembed(params, cfg, j_L.norm_apply(params["final_norm"], h, cfg.norm))
    nll = jax.nn.logsumexp(logits, -1) - jnp.take_along_axis(
        logits, batch["labels"][..., None], -1)[..., 0]
    return jnp.mean(nll) + 0.01 * aux


def _p_fp32_loss(params, cfg, batch):
    h, positions = p_tf._embed_inputs(params, cfg, batch, dtype=torch.float32)
    h, aux, _ = p_tf._stack_forward(params, cfg, h, positions, None)
    logits = p_tf._unembed(params, cfg, p_L.norm_apply(params["final_norm"], h, cfg.norm))
    nll, _ = p_L.xent_terms(logits, batch["labels"])
    return nll.mean() + (0.0 if aux is None else 0.01 * aux)


# fp32 activations through the whole stack: the flash backward rounds p,
# dout and ds to bf16 on both sides (an entry on a rounding boundary can
# round apart), so the bound is well above fp32 rounding
FP32_LOSS_TOL, FP32_GRAD_TOL = 1e-5, 2e-3


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_fp32_stack_grads_match_jax(arch):
    """The grads of a loss through the whole stack in fp32 activations
    (embedding or frontend, every layer with its remat, the final norm, the
    unembedding, plus 0.01 x the MoE aux), built from each package's own
    pieces, against ``jax.value_and_grad``."""
    jcfg, pcfg = _cfgs(arch)
    np_params = _params(arch)
    batch = _train_batch(jcfg)
    j_val, j_grads = jax.jit(jax.value_and_grad(
        lambda p: _j_fp32_loss(p, jcfg, _j(batch))))(jax.tree.map(jnp.asarray, np_params))
    leaves = [x.requires_grad_() for x in tree.leaves(
        convert.params_from_jax(np_params, "cpu"))]
    p_params = tree.unflatten(_params(arch), leaves)
    p_val = _p_fp32_loss(p_params, pcfg, _p(batch))
    grads = torch.autograd.grad(p_val, leaves, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    assert abs(float(p_val.detach()) - float(j_val)) <= FP32_LOSS_TOL
    _grads_close(tree.unflatten(p_params, grads), j_grads, FP32_GRAD_TOL)


@pytest.mark.parametrize("arch", [a for a in NEW_ARCHS if get_config(a).supports_decode])
def test_prefill_then_decode_consistency(arch):
    """Prefill S tokens then decode token S against a prefill of S + 1
    tokens (tests/test_models.py's check and tolerances, on the port
    alone): bf16, but xLSTM in fp32 with its per-layer budget."""
    cfg = smoke_config(arch)
    params = convert.params_from_jax(_params(arch), "cpu")
    S = 64
    xlstm = arch == "xlstm-125m"
    dtype = torch.float32 if xlstm else torch.bfloat16
    full = _p(_inputs(cfg, S + 1, seed=2))
    prompt = dict(full, tokens=full["tokens"][:, :S])
    cache = p_tf.cache_init(cfg, B, S + 8, "cpu")
    _, cache = p_tf.prefill(params, cfg, prompt, cache, dtype=dtype)
    d, _ = p_tf.decode_step(params, cfg, full["tokens"][:, S:], cache, S, dtype=dtype)
    f, _ = p_tf.prefill(params, cfg, full, p_tf.cache_init(cfg, B, S + 8, "cpu"),
                        dtype=dtype)
    d, f = d.numpy(), f.numpy()
    if xlstm:
        np.testing.assert_allclose(d, f, rtol=0.1, atol=XLSTM_PER_LAYER * cfg.num_layers)
        assert np.abs(d - f).mean() < 0.015 * cfg.num_layers
        assert (d.argmax(-1) == f.argmax(-1)).mean() > 0.95
    else:
        np.testing.assert_allclose(d, f, rtol=CONSISTENCY_TOL, atol=CONSISTENCY_TOL)


# tests/test_models.py::test_full_config_abstract_init's expected scales
EXPECTED_SCALE = {
    "recurrentgemma-2b": 2e9, "chatglm3-6b": 6e9, "command-r-35b": 35e9,
    "gemma3-12b": 12e9, "llama3-8b": 8e9, "llava-next-mistral-7b": 7e9,
    "hubert-xlarge": 1e9, "llama4-maverick-400b-a17b": 400e9,
    "dbrx-132b": 132e9, "xlstm-125m": 125e6,
}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_full_config_param_counts(arch):
    """Shapes of the full configs on the meta device: the JAX test's ranges,
    and leaf for leaf the JAX abstract init's shapes."""
    assert jax_fields(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
    params = p_tf.init(torch.Generator(), get_config(arch), "meta")
    n = p_tf.param_count(params)
    assert 0.4 * EXPECTED_SCALE[arch] < n < 2.6 * EXPECTED_SCALE[arch], (arch, n)
    shapes, _ = j_step.abstract_params(j_get_config(arch))
    assert [tuple(x.shape) for x in tree.leaves(params)] == \
        [x.shape for x in jax.tree.leaves(shapes)]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_tree_round_trip_through_convert(arch):
    np_params = _params(arch)
    p_params = convert.params_from_jax(np_params, "cpu")
    back = convert.params_to_numpy(p_params)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert p_tf.param_count(p_params) == j_tf.param_count(np_params)
    # the port's own init has the JAX tree's structure, shapes and dtypes
    own = convert.params_to_numpy(p_tf.init(torch.Generator().manual_seed(0),
                                            smoke_config(arch), "cpu"))
    assert jax.tree.structure(own) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(np_params)):
        assert a.shape == b.shape and a.dtype == b.dtype


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_by_leaf_bf16_init_is_the_cast_of_the_fp32_init(arch):
    """``init(..., dtype=bf16)`` (the serving build on the card: each unit
    slice of a leaf cast as it is drawn) is bitwise ``cast_params(init(...),
    bf16)`` from the same generator state, and casts exactly the leaves the
    forward casts at use. Every arch, at two units and a trailing layer
    where its unit has more than one (MoE: the smoke config's 4 experts),
    so that the unit and expert slices are drawn one after another."""
    ul = p_tf.unit_len(smoke_config(arch))
    cfg = dataclasses.replace(smoke_config(arch), num_layers=2 * ul + (ul > 1))
    n_units, n_rest, _ = p_tf.unit_layout(cfg)
    assert n_units == 2 and n_rest == (ul > 1)
    want = p_tf.cast_params(p_tf.init(torch.Generator().manual_seed(3), cfg, "cpu"),
                            torch.bfloat16)
    got = p_tf.init(torch.Generator().manual_seed(3), cfg, "cpu", dtype=torch.bfloat16)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    kept = {"w_r", "w_i", "up", "down", "wq", "wk", "wv", "wi", "wf", "r",
            "ffn_up", "ffn_down"}                  # used in fp32 at any dtype

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, (*path, k))
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, path)
        else:
            bf16 = t.dtype == torch.bfloat16
            key, parent = path[-1], path[-2] if len(path) > 1 else None
            if parent == "mix" and (key in kept or key == "w"):
                assert not bf16, path     # xLSTM's matrices, RG-LRU's gates
            if key in ("scale", "bias", "b", "lam", "conv_b", "bi", "bf"):
                assert not bf16, path
            if key in ("table", "pos", "conv_w") or (parent == "ffn" and key in (
                    "gate", "up", "down")) or (key == "w" and parent != "mix"):
                assert bf16, path

    walk(got, ())


def test_serve_entry_point_takes_every_arch(capsys):
    """``python -m repro_torch.serve --arch <any>``: hubert runs the encoder
    forward on frame embeddings and prints no decode line; llava prefills
    with patch embeddings."""
    for arch in NEW_ARCHS:
        out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "24", "--gen", "3"])
        lines = capsys.readouterr().out.splitlines()
        assert lines[-1] == "[serve] all finite logits: True", (arch, lines)
        if arch == "hubert-xlarge":
            assert lines[0] == ("[serve] arch=hubert-xlarge batch=2 frames=24 "
                                "(encoder forward, no decode)")
            assert out["tokens"] is None and len(lines) == 2
        else:
            assert lines[0] == f"[serve] arch={arch} batch=2 prompt=24 generated=3"
            assert out["tokens"].shape == (2, 3)
        if arch == "llava-next-mistral-7b":
            assert out["inputs"]["patch_embeds"].shape == (2, 8, 64)


@pytest.mark.parametrize("arch", ["hubert-xlarge", "llava-next-mistral-7b"])
def test_launcher_batches_carry_the_frontends(arch):
    """The launcher's batches hold the frontend's inputs with the shapes of
    the JAX input specs (train) and federation validation specs, and one
    training step of the smoke config runs through ``main``."""
    from repro.core import dfl as j_dfl
    from repro.configs import SHAPES
    from repro_torch.core import dfl as p_dfl
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.launch import train
    jcfg, pcfg = _cfgs(arch)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32, global_batch=2)
    want = j_step.input_specs(jcfg, shape)
    got = train.model_batch(pcfg, TokenPipeline(pcfg.vocab_size, 2, 32).batch_at(0), 0)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    j_val = j_dfl.val_batch_specs(jcfg, j_dfl.DFLConfig(), 3)
    p_val = p_dfl.val_batch_specs(pcfg, p_dfl.DFLConfig(), 3)
    assert {k: (v[0], str(v[1])[6:]) for k, v in p_val.items()} == {
        k: (tuple(v.shape), str(v.dtype)) for k, v in j_val.items()}
    _, history = train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "1",
                             "--batch", "2", "--seq", "32"])
    assert np.isfinite(history[0]["loss"])
