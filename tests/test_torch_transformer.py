"""The port's transformer serving path held against the JAX package's
``repro.models.transformer`` at smoke size, on the same params (JAX init,
norm scales perturbed with numpy, carried across with
``repro_torch.convert``) and the same numpy prompts: prefill logits, 8
decode steps and the KV caches they leave, for llama3-8b (global
attention; a prompt on the block grid and a ragged one) and gemma3-12b
(5 local : 1 global, window 32: the band and the ring-buffer cache, with
the prompt and the decode both past the window).

Tolerances. fp32 (activations and caches fp32 on both sides): logits
within rtol = atol = 1e-4, caches within 1e-5 (the same arithmetic,
summed in another order). bf16: the largest gap within 5e-2 of the largest
magnitude (of the logits; of each cache leaf), and the argmax the same on
at least 90% of the rows. bf16 rounds at other points in the two
frameworks (silu, matmul outputs, p before P.V), and the gaps grow with
depth: measured worst 0.032 on logits up to 2.7 for llama3's 2 layers,
0.066 (2.5e-2 of the scale) for gemma3's 12, every argmax equal. The
bf16 decode feeds the JAX tokens to both sides, so a near-tie in an
argmax cannot send the two down different paths."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import smoke_config as j_smoke_config       # noqa: E402
from repro.models import transformer as j_tf                   # noqa: E402

from repro_torch import convert, serve, tree                   # noqa: E402
from repro_torch.configs import ArchConfig, get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import RGLRU, jax_fields         # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches       # noqa: E402
from repro_torch.models import transformer as p_tf             # noqa: E402

B, GEN = 2, 8
F32_TOL = {"logits": 1e-4, "cache": 1e-5}
BF16_SCALE_TOL = 5e-2


def _close(got, want, dtype, what):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32_TOL[what], atol=F32_TOL[what])
    else:
        gap, scale = np.abs(got - want).max(), np.abs(want).max()
        assert gap <= BF16_SCALE_TOL * scale, (what, gap, scale)


def _np_params(arch, seed=0):
    cfg = j_smoke_config(arch)
    params, _ = j_tf.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        x = np.asarray(x)
        if "scale" in jax.tree_util.keystr(path):   # norm scales: not all ones
            x = (x + 0.2 * rng.standard_normal(x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, params)


_PARAMS = {}


def _params(arch):
    if arch not in _PARAMS:
        _PARAMS[arch] = _np_params(arch)
    return _PARAMS[arch]


_J_PREFILL = jax.jit(j_tf.prefill, static_argnums=(1, 4))
_J_DECODE = jax.jit(j_tf.decode_step, static_argnums=(1, 5))


def _jax_cache(cfg, P, dtype):
    cache, _ = j_tf.cache_init(cfg, B, P + GEN + 1)
    return jax.tree.map(lambda x: x.astype(dtype), cache)


def _cache_leaves(cache):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(cache)]


@pytest.mark.parametrize("arch,P", [("llama3-8b", 32), ("llama3-8b", 40),
                                    ("gemma3-12b", 40)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(arch, P, dtype):
    jcfg, pcfg = j_smoke_config(arch), smoke_config(arch)
    assert jax_fields(pcfg) == dataclasses.asdict(jcfg)   # copied configs
    np_params = _params(arch)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    prompts = np.random.RandomState(P).randint(0, jcfg.vocab_size, (B, P))

    j_cache = _jax_cache(jcfg, P, jd)
    j_logits, j_cache = _J_PREFILL(jax.tree.map(jnp.asarray, np_params), jcfg,
                                   {"tokens": jnp.asarray(prompts, jnp.int32)},
                                   j_cache, jd)
    p_params = convert.params_from_jax(np_params, "cpu")
    p_cache = p_tf.cache_init(pcfg, B, P + GEN + 1, "cpu", dtype=td)
    reset_launches()
    p_logits, p_cache = p_tf.prefill(p_params, pcfg,
                                     {"tokens": torch.from_numpy(prompts)},
                                     p_cache, dtype=td)
    assert LAUNCHES["flash_attention"] == 0          # CPU: the plain version
    assert p_logits.dtype == torch.float32 and p_logits.shape == (B, jcfg.vocab_size)
    _close(p_logits.numpy(), np.asarray(j_logits), dtype, "logits")

    j_tok = jnp.argmax(j_logits, -1)[:, None]
    p_tok = torch.argmax(p_logits, -1)[:, None]
    same_argmax = [np.array_equal(p_tok.numpy(), np.asarray(j_tok))]
    for i in range(GEN):
        if dtype == "bfloat16":
            p_tok = torch.from_numpy(np.array(j_tok)).long()
        j_logits, j_cache = _J_DECODE(jax.tree.map(jnp.asarray, np_params), jcfg,
                                      j_tok, j_cache, jnp.asarray(P + i, jnp.int32),
                                      jd)
        p_logits, p_cache = p_tf.decode_step(p_params, pcfg, p_tok, p_cache, P + i,
                                             dtype=td)
        _close(p_logits.numpy(), np.asarray(j_logits), dtype, "logits")
        j_tok = jnp.argmax(j_logits, -1)[:, None]
        p_tok = torch.argmax(p_logits, -1)[:, None]
        same_argmax.append(np.array_equal(p_tok.numpy(), np.asarray(j_tok)))
    if dtype == "float32":
        assert all(same_argmax)          # greedy on both sides, same tokens
    else:
        assert np.mean(same_argmax) >= 0.9
    # the caches left behind: same layout (ring slots included), same values
    assert p_cache["rest"] is None and j_cache["rest"] is None
    got = tree.leaves(convert.params_to_numpy(p_cache["units"]))
    want = _cache_leaves(j_cache["units"])
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        _close(g, w, dtype, "cache")


def test_prefill_then_decode_consistency():
    """Prefill S tokens then decode token S against a prefill of S + 1 tokens
    (tests/test_models.py's check and bf16 tolerance, on the port alone)."""
    for arch in ("llama3-8b", "gemma3-12b"):
        cfg = smoke_config(arch)
        params = convert.params_from_jax(_params(arch), "cpu")
        S = 40
        toks = torch.from_numpy(np.random.RandomState(2).randint(
            0, cfg.vocab_size, (B, S + 1)))
        cache = p_tf.cache_init(cfg, B, S + 8, "cpu")
        _, cache = p_tf.prefill(params, cfg, {"tokens": toks[:, :S]}, cache)
        logits_d, _ = p_tf.decode_step(params, cfg, toks[:, S:], cache, S)
        logits_f, _ = p_tf.prefill(params, cfg, {"tokens": toks},
                                   p_tf.cache_init(cfg, B, S + 8, "cpu"))
        torch.testing.assert_close(logits_d, logits_f, rtol=0.08, atol=0.08)


def test_bf16_weight_copy_gives_the_same_logits():
    cfg = smoke_config("llama3-8b")
    params = convert.params_from_jax(_params("llama3-8b"), "cpu")
    weights = p_tf.cast_params(params, torch.bfloat16)
    assert weights["units"][0]["mix"]["q"]["w"].dtype == torch.bfloat16
    assert weights["units"][0]["norm1"]["scale"] is params["units"][0]["norm1"]["scale"]
    toks = torch.from_numpy(np.random.RandomState(3).randint(0, 256, (B, 24)))
    outs = []
    for p in (params, weights):
        cache = p_tf.cache_init(cfg, B, 32, "cpu")
        logits, cache = p_tf.prefill(p, cfg, {"tokens": toks}, cache)
        logits2, _ = p_tf.decode_step(p, cfg, toks[:, :1], cache, 24)
        outs.append((logits, logits2))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


def test_transformer_tree_round_trip_through_convert():
    np_params = _params("gemma3-12b")
    p_params = convert.params_from_jax(np_params, "cpu")
    assert isinstance(p_params["units"], tuple) and len(p_params["units"]) == 6
    back = convert.params_to_numpy(p_params)
    j_leaves = jax.tree.leaves(np_params)
    assert jax.tree.structure(back) == jax.tree.structure(np_params)
    for a, b in zip(jax.tree.leaves(back), j_leaves):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # bf16 leaves (ml_dtypes on the JAX side) come across exactly
    bf = jax.tree.map(lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16)), np_params)
    p_bf = convert.params_from_jax(bf, "cpu")
    assert tree.leaves(p_bf)[0].dtype == torch.bfloat16
    for a, b in zip(tree.leaves(convert.params_to_numpy(p_bf)), jax.tree.leaves(bf)):
        assert np.array_equal(a, b.astype(np.float32))
    assert p_tf.param_count(p_params) == j_tf.param_count(np_params)


def test_full_llama3_8b_param_count():
    params = p_tf.init(torch.Generator(), get_config("llama3-8b"), "meta")
    assert p_tf.param_count(params) == 8_030_261_248
    assert params["units"][0]["ffn"]["gate"]["w"].shape == (32, 4096, 14336)


def test_unported_kinds_raise():
    """No layer kind or remat policy of the model raises as unported: an
    RG-LRU-only config serves, and trains under remat="dots" with the loss
    and grads of remat="full", within the training step's tolerances of
    JAX's remat="dots" loss and grads (tests/test_torch_train_step.py:
    loss 5e-3, each grad leaf 6e-2 relative L2) from the same params."""
    from repro.configs import ArchConfig as JArchConfig
    from repro_torch.train import step as p_step
    kw = dict(name="rg", family="ssm", num_layers=2, d_model=64, num_heads=4,
              num_kv_heads=1, d_ff=128, vocab_size=256, block_pattern=(RGLRU,))
    cfg = ArchConfig(**kw, remat="dots")
    jcfg = JArchConfig(**kw, remat="dots")
    np_params = jax.tree.map(np.asarray, j_tf.init(jax.random.PRNGKey(0), jcfg)[0])
    params = convert.params_from_jax(np_params, "cpu")
    toks = np.random.RandomState(0).randint(0, 256, (2, 32)).astype(np.int32)
    with torch.no_grad():
        logits, _ = p_tf.prefill(params, cfg, {"tokens": torch.as_tensor(toks)}, None)
    assert logits.shape == (2, 256)
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(toks)}
    loss, _, grads = p_step.loss_and_grads(params, cfg, batch)
    f_loss, _, f_grads = p_step.loss_and_grads(
        params, dataclasses.replace(cfg, remat="full"), batch)
    assert torch.equal(loss, f_loss)
    assert all(torch.equal(a, b) for a, b in zip(tree.leaves(grads), tree.leaves(f_grads)))
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_tf.train_loss(p, jcfg, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(toks)}),
        has_aux=True)(jax.tree.map(jnp.asarray, np_params))
    assert abs(float(loss) - float(j_loss)) <= 5e-3
    for got, want in zip(tree.leaves(convert.params_to_numpy(grads)),
                         jax.tree.leaves(j_grads)):
        want = np.asarray(want)
        assert np.linalg.norm(got - want) <= 6e-2 * np.linalg.norm(want)


def test_serve_entry_point(capsys, monkeypatch):
    out = serve.main(["--smoke", "--device", "cpu", "--prompt-len", "40",
                      "--gen", "5"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == "[serve] arch=llama3-8b batch=4 prompt=40 generated=5"
    assert lines[2] == "[serve] all finite logits: True"
    assert out["tokens"].shape == (4, 5)
    assert out["cache"]["units"][0]["k"].shape == (2, 4, 45, 2, 16)
    # the default device is the card, never a silent CPU fallback
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        serve.main(["--smoke", "--prompt-len", "8", "--gen", "2"])


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-12b"])
def test_configs_are_copies_of_the_jax_ones(arch):
    from repro.configs import get_config as j_get_config
    assert jax_fields(get_config(arch)) == dataclasses.asdict(j_get_config(arch))
