"""The port's optimizers, schedules, token pipeline and cross entropy held
against the JAX package (``repro.optim``, ``repro.data``,
``repro.models.layers.softmax_xent``) on the same numpy inputs.

Tolerances: schedules, and optimizer updates, params and state in fp32,
within 1e-6 relative (the same operations in the same order; a pow or
rsqrt may differ in the last bit): each element within rtol 1e-6 of its
reference or within 1e-6 of its leaf's largest magnitude (a param that an
update nearly cancels keeps the update's last-bit difference). Batches
and streams exactly."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data.pipeline import TokenPipeline as JPipe           # noqa: E402
from repro.data.synthetic import SyntheticTokens as JTokens      # noqa: E402
from repro.models import layers as j_layers                     # noqa: E402
from repro.optim import optimizers as j_opt                     # noqa: E402
from repro.optim import schedules as j_sched                    # noqa: E402

from repro_torch import tree                                    # noqa: E402
from repro_torch.data.pipeline import TokenPipeline             # noqa: E402
from repro_torch.data.synthetic import SyntheticTokens          # noqa: E402
from repro_torch.models import layers as p_layers               # noqa: E402
from repro_torch.optim import optimizers as p_opt               # noqa: E402
from repro_torch.optim import schedules as p_sched              # noqa: E402

RTOL = 1e-6
SCHEDULES = {
    "constant": lambda m: m.constant(3e-4),
    "warmup_cosine": lambda m: m.warmup_cosine(3e-4, 10, 50),
    "warmup_cosine_short": lambda m: m.warmup_cosine(1e-3, 0, 1),
    "caffe_inv": lambda m: m.caffe_inv(0.01),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match(name):
    jf, pf = SCHEDULES[name](j_sched), SCHEDULES[name](p_sched)
    for s in (0, 1, 5, 9, 10, 11, 30, 49, 50, 80, 20_000):
        want = np.asarray(jf(jnp.asarray(s, jnp.int32)))
        got = pf(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, err_msg=f"step {s}")
        np.testing.assert_allclose(pf(s).numpy(), want, rtol=RTOL)


def _tree(rng, scale=1.0):
    return {"a": {"w": (scale * rng.standard_normal((6, 5))).astype(np.float32)},
            "b": (scale * rng.standard_normal((7,))).astype(np.float32),
            "c": [(scale * rng.standard_normal((2, 3, 4))).astype(np.float32)]}


def _t(x):
    return tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def _close(got, want, what):
    for g, w in zip(tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=RTOL * np.abs(w).max(), err_msg=what)


OPTIMIZERS = {
    "adamw": dict(),
    "adamw_nowd": dict(weight_decay=0.0, b2=0.999),
    "sgdm": dict(),
    "sgdm_wd": dict(weight_decay=1e-2, momentum=0.5),
    "adafactor": dict(),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_on_the_same_grads(name):
    """Four steps of init/update/apply_updates, each on fresh grads, with
    global-norm clipping in front as the train step has it."""
    kind, hp = name.split("_")[0], OPTIMIZERS[name]
    rng = np.random.RandomState(0)
    params = _tree(rng)
    jo = j_opt.make_optimizer(kind, j_sched.warmup_cosine(1e-2, 2, 10), **hp)
    po = p_opt.make_optimizer(kind, p_sched.warmup_cosine(1e-2, 2, 10), **hp)
    jp = jax.tree.map(jnp.asarray, params)
    js = jo.init(jp)
    pp = _t(params)
    ps = po.init(pp)
    _close(tree.leaves(ps), jax.tree.leaves(js), "init")
    for step in range(4):
        grads = _tree(rng, scale=3.0 if step == 1 else 0.1)
        jg, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, grads), 1.0)
        pg, pn = p_opt.clip_by_global_norm(_t(grads), 1.0)
        np.testing.assert_allclose(pn.numpy(), np.asarray(jn), rtol=RTOL)
        _close(pg, jg, f"clipped grads {step}")
        ju, js = jo.update(jg, js, jp, jnp.asarray(step, jnp.int32))
        jp = j_opt.apply_updates(jp, ju)
        pu, ps = po.update(pg, ps, pp, torch.tensor(step, dtype=torch.int32))
        _close(pu, ju, f"updates {step}")
        pp = p_opt.apply_updates(pp, pu)
        _close(pp, jp, f"params {step}")
        _close(tree.leaves(ps, is_leaf=lambda x: isinstance(x, torch.Tensor)),
               jax.tree.leaves(js), f"state {step}")


def test_global_norm_and_unknown_optimizer():
    rng = np.random.RandomState(1)
    t = _tree(rng)
    np.testing.assert_allclose(p_opt.global_norm(_t(t)).numpy(),
                               np.asarray(j_opt.global_norm(t)), rtol=RTOL)
    with pytest.raises(KeyError):
        p_opt.make_optimizer("lion", p_sched.constant(1.0))


@pytest.mark.parametrize("vocab,seed,branch", [(256, 0, 4), (1000, 3, 2)])
def test_synthetic_tokens_match(vocab, seed, branch):
    j, p = JTokens(vocab, seed, branch), SyntheticTokens(vocab, seed, branch)
    np.testing.assert_array_equal(j.next_tokens, p.next_tokens)
    a = j.batch(np.random.RandomState(5), 3, 17)
    b = p.batch(np.random.RandomState(5), 3, 17)
    for k in ("tokens", "labels"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


def test_token_pipeline_batches_match_exactly():
    j = JPipe(256, 4, 32, seed=7, fed_nodes=3)
    p = TokenPipeline(256, 4, 32, seed=7, fed_nodes=3)
    for step, node in ((0, 0), (5, 2), (10_003, 1)):
        a, b = j.batch_at(step, node), p.batch_at(step, node)
        for k in ("tokens", "labels"):
            np.testing.assert_array_equal(a[k], b[k])
    a, b = j.fed_batches(2, 3), p.fed_batches(2, 3)
    for k in ("tokens", "labels"):
        assert b[k].shape == (3, 3, 4, 32)
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("masked", [False, True])
def test_softmax_xent_matches(masked):
    rng = np.random.RandomState(2)
    logits = (3 * rng.standard_normal((2, 9, 11))).astype(np.float32)
    labels = rng.randint(0, 11, (2, 9)).astype(np.int32)
    labels[0, :3] = logits[0, :3].argmax(-1)            # some hits
    mask = (rng.uniform(size=(2, 9)) > 0.3).astype(np.float32) if masked else None
    jl, ja = j_layers.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                   None if mask is None else jnp.asarray(mask))
    pl, pa = p_layers.softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels),
                                   None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=RTOL)
    np.testing.assert_allclose(pa.numpy(), np.asarray(ja), rtol=RTOL)
