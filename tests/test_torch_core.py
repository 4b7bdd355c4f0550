"""The port's core math held against the JAX package on the same numpy
inputs: Eq. 2/3 FedAvg (rtol 1e-6: sums in another order), reputation
rows (exact), int8 wire compression (bitwise) and wire-byte accounting
(exact)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import compression as j_comp                    # noqa: E402
from repro.core import fedavg as j_fedavg                       # noqa: E402
from repro.core import topology as j_topology                   # noqa: E402
from repro.core.reputation import IMPL1 as J_IMPL1              # noqa: E402
from repro.core.reputation import IMPL2 as J_IMPL2              # noqa: E402
from repro.data import partition as j_partition                 # noqa: E402
from repro.data.synthetic import SyntheticMnist as JMnist        # noqa: E402

from repro_torch import convert, tree                           # noqa: E402
from repro_torch.core import compression as p_comp              # noqa: E402
from repro_torch.core import fedavg as p_fedavg                 # noqa: E402
from repro_torch.core import topology as p_topology             # noqa: E402
from repro_torch.core.reputation import IMPL1 as P_IMPL1        # noqa: E402
from repro_torch.core.reputation import IMPL2 as P_IMPL2        # noqa: E402
from repro_torch.data import partition as p_partition           # noqa: E402
from repro_torch.data.synthetic import SyntheticMnist as PMnist  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _lenet_like_tree(rng):
    """A tree with LeNet's leaf shapes (HWIO convs, (in, out) dense)."""
    shapes = {"c1": {"w": (5, 5, 1, 6), "b": (6,)},
              "c2": {"w": (5, 5, 6, 16), "b": (16,)},
              "f1": {"w": (784, 120), "b": (120,)},
              "f2": {"w": (120, 84), "b": (84,)},
              "out": {"w": (84, 10), "b": (10,)}}
    return {k: {kk: (0.2 * rng.standard_normal(s)).astype(np.float32)
                for kk, s in v.items()} for k, v in shapes.items()}


# ------------------------------------------------------------------ fedavg
@pytest.mark.parametrize("weights", [[0.1, 0.4, 0.0, 0.5], [0.0, 0.0, 0.0, 0.0],
                                     [3.0, 1.0, 2.0, 0.5]])
def test_weighted_fedavg_matches_jax(weights):
    rng = np.random.RandomState(0)
    ms = {"w": rng.standard_normal((4, 32, 8)).astype(np.float32),
          "b": rng.standard_normal((4, 16)).astype(np.float32)}
    prev = {"w": rng.standard_normal((32, 8)).astype(np.float32),
            "b": np.ones((16,), np.float32)}
    w = np.asarray(weights, np.float32)
    want = jax.jit(j_fedavg.weighted_fedavg)(
        jax.tree.map(jnp.asarray, ms), jnp.asarray(w),
        jax.tree.map(jnp.asarray, prev))
    got = p_fedavg.weighted_fedavg(tree.map(_t, ms), _t(w), tree.map(_t, prev))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6)
    if not np.any(w):     # zero total weight keeps prev exactly
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[k].numpy(), prev[k])


def test_streaming_fedavg_matches_jax_and_stacked():
    rng = np.random.RandomState(1)
    models = [rng.standard_normal((64,)).astype(np.float32) for _ in range(3)]
    ws = np.asarray([0.3, 0.0, 0.9], np.float32)
    prev = rng.standard_normal((64,)).astype(np.float32)
    j_state = j_fedavg.streaming_init({"w": jnp.asarray(prev)})
    p_state = p_fedavg.streaming_init({"w": _t(prev)})
    for m, w in zip(models, ws):
        j_state = j_fedavg.streaming_add(j_state, {"w": jnp.asarray(m)},
                                         jnp.asarray(w))
        p_state = p_fedavg.streaming_add(p_state, {"w": _t(m)}, _t(w))
    want = j_fedavg.streaming_finish(j_state, {"w": jnp.asarray(prev)})["w"]
    got = p_fedavg.streaming_finish(p_state, {"w": _t(prev)})["w"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    stacked = p_fedavg.weighted_fedavg({"w": _t(np.stack(models))}, _t(ws),
                                       {"w": _t(prev)})["w"]
    np.testing.assert_allclose(got.numpy(), stacked.numpy(), rtol=1e-6, atol=1e-6)
    zero = p_fedavg.streaming_finish(p_fedavg.streaming_init({"w": _t(prev)}),
                                     {"w": _t(prev)})["w"]
    np.testing.assert_array_equal(zero.numpy(), prev)
    assert float(p_fedavg.model_weights(_t(np.float32(0.5)),
                                        _t(np.float32(0.25)))) == 0.125


# -------------------------------------------------------------- reputation
@pytest.mark.parametrize("impls", [(J_IMPL1, P_IMPL1), (J_IMPL2, P_IMPL2)])
@pytest.mark.parametrize("case", ["ties", "floor", "empty", "plain"])
def test_update_row_matches_jax_exactly(impls, case):
    j_impl, p_impl = impls
    row = np.asarray([1.0, 0.9, 0.02, 0.5, 0.7], np.float32)
    ids = np.asarray([0, 2, 3, 4], np.int32)
    accs = {"ties": [0.3, 0.1, 0.1, 0.8], "floor": [0.9, 0.0, 0.5, 0.6],
            "empty": [], "plain": [0.4, 0.6, 0.2, 0.9]}[case]
    accs = np.asarray(accs, np.float32)
    if case == "empty":
        ids = ids[:0]
    want = np.asarray(j_impl.update_row(jnp.asarray(row), jnp.asarray(ids),
                                        jnp.asarray(accs)))
    got = p_impl.update_row(_t(row), _t(ids), _t(accs)).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "empty":
        np.testing.assert_array_equal(got, row)
    assert got.min() >= p_impl.floor


# ------------------------------------------------------------- compression
@pytest.mark.parametrize("shape", [(7, 6), (3, 120), (4, 256), (5, 300),
                                   (2, 3, 520), (6,), (), (0,), (3, 0), (0, 5)])
def test_quantize_last_axis_bitwise(shape):
    rng = np.random.RandomState(len(shape) * 31 + sum(shape))
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    if x.size > 4:
        x.reshape(-1)[:4] = [0.0, 1e-30, -1e-30, 0.0]    # tiny and zero values
    jq, js = jax.jit(j_comp.quantize_last_axis)(jnp.asarray(x))
    pq, ps = p_comp.quantize_last_axis(_t(x))
    assert tuple(pq.shape) == jq.shape and tuple(ps.shape) == js.shape
    assert ps.dtype == torch.bfloat16
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.to(torch.float32).numpy(),
                                  np.asarray(js, np.float32))
    jd = jax.jit(j_comp.dequantize_last_axis, static_argnums=(2, 3))(
        jq, js, shape, jnp.float32)
    pd = p_comp.dequantize_last_axis(pq, ps, shape, torch.float32)
    assert tuple(pd.shape) == shape
    np.testing.assert_array_equal(pd.numpy(), np.asarray(jd))


@pytest.mark.parametrize("shape", [(0,), (3, 0), (), (5,), (256,), (257,),
                                   (7, 33, 5), (784, 120)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_tensor_bitwise(shape, dtype):
    """The flat-block forms: pad to whole 256-element blocks, bf16 wire
    scales, size 0 gives 0 blocks; q, scales and the dequantized tensor in
    fp32 and bf16 bitwise to the JAX package's."""
    rng = np.random.RandomState(len(shape) * 17 + sum(shape))
    x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
    if x.size > 300:
        x.reshape(-1)[:256] = 0.0                          # an all-zero block
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    px = _t(x).to(getattr(torch, dtype))
    jq, js = jax.jit(j_comp.quantize_tensor)(jx)
    pq, ps = p_comp.quantize_tensor(px)
    assert tuple(pq.shape) == jq.shape and tuple(ps.shape) == js.shape
    assert pq.dtype == torch.int8 and ps.dtype == torch.bfloat16
    np.testing.assert_array_equal(pq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ps.to(torch.float32).numpy(),
                                  np.asarray(js, np.float32))
    for out in ("float32", "bfloat16"):
        jd = jax.jit(j_comp.dequantize_tensor, static_argnums=(2, 3))(
            jq, js, shape, getattr(jnp, out))
        pd = p_comp.dequantize_tensor(pq, ps, shape, getattr(torch, out))
        assert tuple(pd.shape) == shape and pd.dtype == getattr(torch, out)
        np.testing.assert_array_equal(pd.to(torch.float32).numpy(),
                                      np.asarray(jd, np.float32))


def test_roundtrip_tree_bitwise_on_lenet_tree():
    params = _lenet_like_tree(np.random.RandomState(3))
    want = jax.jit(j_comp.roundtrip_tree)(jax.tree.map(jnp.asarray, params))
    got = p_comp.roundtrip_tree(convert.params_from_jax(params, "cpu"))
    for j_leaf, p_leaf in zip(jax.tree.leaves(want), tree.leaves(got)):
        np.testing.assert_array_equal(p_leaf.numpy(), np.asarray(j_leaf))
    # a 0-d leaf and a zero-size leaf survive the round trip
    odd = {"s": np.float32(2.5), "z": np.zeros((4, 0), np.float32)}
    got = p_comp.roundtrip_tree(tree.map(_t, odd))
    want = jax.jit(j_comp.roundtrip_tree)(jax.tree.map(jnp.asarray, odd))
    assert tuple(got["z"].shape) == (4, 0)
    np.testing.assert_array_equal(got["s"].numpy(), np.asarray(want["s"]))


@pytest.mark.parametrize("compress", [None, "int8"])
def test_payload_bytes_match_jax(compress):
    params = _lenet_like_tree(np.random.RandomState(4))
    params["extra"] = {"s": np.float32(1.0), "z": np.zeros((3, 0), np.float32),
                       "h": np.zeros((2, 300), np.float32)}
    want = j_comp.payload_bytes(jax.tree.map(jnp.asarray, params), compress)
    got = p_comp.payload_bytes(tree.map(_t, params), compress)
    assert got == want
    with pytest.raises(ValueError):
        p_comp.leaf_wire_bytes((3,), torch.float32, "fp4")


# ------------------------------------------------- data and topology copies
def test_data_and_topology_copies_are_bit_identical():
    j_ds, p_ds = JMnist(seed=3, noise=1.5), PMnist(seed=3, noise=1.5)
    probs = p_partition.dirichlet_class_probs(6, 10, 1.0, seed=3)
    np.testing.assert_array_equal(
        probs, j_partition.dirichlet_class_probs(6, 10, 1.0, seed=3))
    ji, jl = j_ds.batch(np.random.RandomState(7), 8, class_probs=probs[1])
    pi, pl = p_ds.batch(np.random.RandomState(7), 8, class_probs=probs[1])
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pl, jl)
    for n, k in [(6, 1), (10, 2), (8, 4)]:
        j_t, p_t = j_topology.kregular(n, k), p_topology.kregular(n, k)
        np.testing.assert_array_equal(p_t.adj, j_t.adj)
        names = [f"n{i}" for i in range(n)]
        assert p_t.as_name_dict(names) == j_t.as_name_dict(names)
        assert p_t.kind == j_t.kind
    np.testing.assert_array_equal(p_topology.make("full", 5).adj,
                                  j_topology.make("full", 5).adj)
    with pytest.raises(ValueError):
        p_topology.make("star", 8)
    with pytest.raises(ValueError):
        p_topology.Topology("bad", np.eye(3, dtype=bool))
