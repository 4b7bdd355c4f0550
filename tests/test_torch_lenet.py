"""The port's LeNet-5 held against the JAX package's on the same params
(carried across with ``repro_torch.convert``) and the same numpy batch:
logits, loss, accuracy and autograd gradients against ``jax.value_and_grad``
at 1e-5 (fp32 convolutions and products sum in another order), one SGD
step, the scenario's train/eval functions, and model fingerprints."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.chain import crypto as j_crypto                     # noqa: E402
from repro.configs.lenet_dfl import CONFIG as J_CFG             # noqa: E402
from repro.models import lenet as j_lenet                      # noqa: E402

from repro_torch import convert, tree                          # noqa: E402
from repro_torch.chain import crypto as p_crypto               # noqa: E402
from repro_torch.chain import scenarios as p_scenarios         # noqa: E402
from repro_torch.configs.lenet_dfl import CONFIG as P_CFG       # noqa: E402
from repro_torch.models import lenet as p_lenet                # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """Params drawn with numpy in the JAX init's shapes (fan-in-scaled
    weights, non-zero biases so every bias path is exercised)."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda: j_lenet.init(jax.random.PRNGKey(0), J_CFG))
    np_params = jax.tree.map(
        lambda s: (rng.standard_normal(s.shape)
                   / np.sqrt(np.prod(s.shape[:-1]) if len(s.shape) > 1 else 20.0)
                   ).astype(np.float32), shapes)
    batch = {"images": rng.rand(8, 28, 28, 1).astype(np.float32),
             "labels": rng.randint(0, 10, size=8).astype(np.int32)}
    return jax.tree.map(jnp.asarray, np_params), np_params, batch


_j_value_and_grad = jax.jit(jax.value_and_grad(j_lenet.loss_and_acc,
                                               has_aux=True))


def _torch_batch(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def test_logits_loss_accuracy_and_grads_match_jax(setup):
    j_params, np_params, batch = setup
    p_params = convert.params_from_jax(np_params, "cpu")
    jb = jax.tree.map(jnp.asarray, batch)
    (j_loss, j_acc), j_grads = _j_value_and_grad(j_params, jb)
    leaves = [x.requires_grad_(True) for x in tree.leaves(p_params)]
    p_loss, p_acc = p_lenet.loss_and_acc(tree.unflatten(p_params, leaves),
                                         _torch_batch(batch))
    p_grads = torch.autograd.grad(p_loss, leaves)
    np.testing.assert_allclose(p_loss.item(), float(j_loss), **TOL)
    assert p_acc.item() == float(j_acc)
    for jg, pg in zip(jax.tree.leaves(j_grads), p_grads):
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), **TOL)
    with torch.no_grad():
        p_logits = p_lenet.forward(p_params, _torch_batch(batch)["images"])
        p_accuracy = p_lenet.accuracy(p_params, *_torch_batch(batch).values())
    np.testing.assert_allclose(
        p_logits.numpy(),
        np.asarray(jax.jit(j_lenet.forward)(j_params, jb["images"])), **TOL)
    assert p_accuracy.item() == float(j_acc)


def test_one_sgd_step_matches_jax(setup):
    """The scenario's own train_fn (one step, batch = the whole pool drawn
    by the generator) against the same step written in JAX."""
    j_params, np_params, batch = setup
    lr = 0.12
    sc = p_scenarios.lenet_scenario(2, train_steps=1, batch=8, lr=lr,
                                    pool=8, eval_size=4, test_size=8)
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 8, (1, 8), generator=g)[0].numpy()
    g.manual_seed(0)                 # train_fn redraws the same indices
    data = _torch_batch(batch)
    stepped = sc.train_fn(convert.params_from_jax(np_params, "cpu"), g, data)
    jb = {k: jnp.asarray(v[idx]) for k, v in batch.items()}
    (_, _), j_grads = _j_value_and_grad(j_params, jb)
    want = jax.tree.map(lambda a, gg: a - lr * gg, j_params, j_grads)
    for jl, pl in zip(jax.tree.leaves(want), tree.leaves(stepped)):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), **TOL)
        assert not pl.requires_grad
    # train_steps=0 returns the params untouched
    sc0 = p_scenarios.lenet_scenario(2, train_steps=0, pool=8, eval_size=4,
                                     test_size=8)
    same = sc0.train_fn(convert.params_from_jax(np_params, "cpu"), g, data)
    for a, b in zip(tree.leaves(same), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a.numpy(), b)


def test_fingerprints_and_conversion_round_trip(setup):
    j_params, np_params, _ = setup
    p_params = convert.params_from_jax(np_params, "cpu")
    assert p_crypto.fingerprint_tree(p_params) == \
        j_crypto.fingerprint_tree(j_params)
    back = convert.params_to_numpy(p_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(np_params)):
        np.testing.assert_array_equal(a, b)
    bf16 = {"w": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}
    t = convert.params_from_jax(bf16, "cpu")["w"]
    assert t.dtype == torch.bfloat16 and t.tolist() == [1.5, -2.25]
    # init draws the JAX layouts at the config's widths: truncated at
    # 2 / sqrt(fan_in) for weights, zero biases
    g = torch.Generator().manual_seed(0)
    p_init = p_lenet.init(g, P_CFG, "cpu")
    for a, b in zip(tree.leaves(p_init), jax.tree.leaves(j_params)):
        assert tuple(a.shape) == b.shape
        if a.dim() == 1:
            assert not a.any()
        else:
            bound = 2.0 / np.sqrt(np.prod(a.shape[:-1]))
            assert 0 < float(a.abs().max()) <= bound * (1 + 1e-6)
