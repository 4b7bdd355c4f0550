"""The int8 wire quantizer's tree API on the CPU: its segment table and
arenas, and its plain version (which walks that table over the arenas) held
bitwise to the JAX package's ``repro.core.compression`` on the same numpy
inputs; the row API's bf16 output held to the Pallas ``dequantize`` in
interpret mode; the table's pointers and vector flags as the kernels get
them; CPU tensors never launch. The tree kernels themselves run only on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import compression as j_comp                       # noqa: E402
from repro.kernels.quantize.quantize import dequantize as j_dequantize  # noqa: E402
from repro.kernels.quantize.quantize import quantize as j_quantize      # noqa: E402

from repro_torch import tree                                       # noqa: E402
from repro_torch.core import compression as p_comp                 # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches           # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops              # noqa: E402
from repro_torch.kernels.quantize import ref as q_ref              # noqa: E402
from repro_torch.kernels.quantize import table                     # noqa: E402

LENET = {"c1": {"w": (5, 5, 1, 6), "b": (6,)},
         "c2": {"w": (5, 5, 6, 16), "b": (16,)},
         "f1": {"w": (784, 120), "b": (120,)},
         "f2": {"w": (120, 84), "b": (84,)},
         "out": {"w": (84, 10), "b": (10,)}}
# name -> {leaf: (shape, dtype)}
TREES = {
    "lenet": {f"{k}.{kk}": (s, "float32") for k, v in LENET.items()
              for kk, s in v.items()},
    "odd": {"s": ((), "float32"), "z": ((4, 0), "float32"),
            "e": ((0, 5), "float32"), "v": ((6,), "float32")},
    "ragged": {"a": ((5, 300), "float32"), "b": ((2, 3, 520), "float32"),
               "c": ((3, 257), "float32")},
    "bf16": {"w": ((64, 120), "bfloat16")},
    "mixed": {"w": ((32, 120), "float32"), "h": ((4, 520), "bfloat16"),
              "b": ((120,), "bfloat16"), "o": ((7, 10), "float32")},
    "many": {f"l{i:02d}": (((i % 5) + 1, 4 + 3 * i), "float32") for i in range(70)},
}


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _make(name, seed=0):
    """The same values for both packages: fp32 from numpy, cast to each
    leaf's type on each side (both round to nearest even)."""
    rng = np.random.RandomState(seed)
    j_tree, p_tree = {}, {}
    for leaf, (shape, dtype) in TREES[name].items():
        x = (3.0 * rng.standard_normal(shape)).astype(np.float32)
        if x.size > 4:
            x.reshape(-1)[:4] = [0.0, 1e-30, -1e-30, 0.0]   # tiny and zero values
        j_tree[leaf] = jnp.asarray(x).astype(getattr(jnp, dtype))
        p_tree[leaf] = _t(x).to(getattr(torch, dtype))
    return j_tree, p_tree


def _np(x):
    return (x.float().numpy() if torch.is_tensor(x)
            else np.asarray(x).astype(np.float32))


def _assert_same(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got), _np(want))


# ---------------------------------------------------------- (a) the table
def test_lenet_segment_table_and_arenas():
    _, p_tree = _make("lenet")
    leaves = tree.leaves(p_tree)
    plan = table.plan_for(leaves, p_comp.BLOCK)
    (group,) = plan.groups                        # ten leaves: one launch
    rows = []
    for x in leaves:
        lead, _, _, nblocks = p_comp._last_axis_blocking(tuple(x.shape))
        rows.append(int(np.prod(lead)) * nblocks)
    assert len(group.leaves) == 10 and group.rows == sum(rows) == 1168
    np.testing.assert_array_equal(group.table["row0"], np.cumsum([0] + rows[:-1]))
    for seg, x in zip(group.table, leaves):
        _, last, b, nblocks = p_comp._last_axis_blocking(tuple(x.shape))
        assert (seg["last"], seg["b"], seg["nblocks"], seg["flags"]) == \
            (last, b, nblocks, 0)
    assert plan.q_bytes == 107786 and plan.n_scales == 1168
    assert plan.q_bytes + 2 * plan.n_scales == p_comp.payload_bytes(p_tree, "int8") \
        == 110122
    # the wire views sit back to back in the arenas; outputs 16-byte aligned
    pairs = q_ops.quantize_tree(leaves)
    q_offs = [q.storage_offset() for q, _ in pairs]
    assert q_offs == [lf.q_off for lf in plan.leaves] == \
        list(np.cumsum([0] + [q.numel() for q, _ in pairs[:-1]]))
    assert [s.storage_offset() for _, s in pairs] == list(
        np.cumsum([0] + rows[:-1]))
    outs = q_ops.roundtrip_tree(leaves)
    assert all(o.storage_offset() * 4 % 16 == 0 for o in outs)
    assert len({o.untyped_storage().data_ptr() for o in outs}) == 1


def test_table_splits_more_than_64_leaves():
    _, p_tree = _make("many")
    plan = table.plan_for(tree.leaves(p_tree), 256)
    assert [len(g.leaves) for g in plan.groups] == [64, 6]
    assert [int(g.table["row0"][0]) for g in plan.groups] == [0, 0]
    assert sum(g.rows for g in plan.groups) == plan.n_scales


def test_filled_table_pointers_and_vector_flags():
    """What the kernels get: pointers at the arenas' offsets, and the
    16-byte path only where the pointers and widths allow it."""
    _, p_tree = _make("mixed")
    plan = table.plan_for(tree.leaves(p_tree), 256)   # b, h, o, w in tree order
    (g,) = plan.groups
    q0, s0, x0 = 1 << 20, 2 << 20, 3 << 20
    tab = q_ops._fill(g, x0 + g.out_offs, q0 + g.q_offs, s0 + g.s_offs, table.S_BF16)
    np.testing.assert_array_equal(tab["q"] - q0, [lf.q_off for lf in plan.leaves])
    np.testing.assert_array_equal(tab["s"] - s0, [2 * lf.s_off for lf in plan.leaves])
    assert list(tab["flags"] & table.X_BF16) == [1, 1, 0, 0]
    assert all(tab["flags"] & table.S_BF16)
    # b (120,) bf16: 120 % 8 == 0 -> vector; h (4, 520) bf16: last 520 and
    # b 256 are multiples of 8 and its q starts at byte 120 -> vector;
    # o (7, 10): 10 % 4 -> scalar; w (32, 120) fp32: its q starts at byte
    # 3262 of the packed wire, not 4-aligned -> scalar
    assert [lf.q_off for lf in plan.leaves] == [0, 120, 3192, 3262]
    assert list(tab["flags"] & table.VEC) == [4, 4, 0, 0]
    misaligned = q_ops._fill(g, x0 + 4 + g.out_offs, q0 + g.q_offs, s0 + g.s_offs, 0)
    assert not any(misaligned["flags"] & table.VEC)
    (row,) = table.plan((((9, 40), torch.float32, 40),)).groups
    one = q_ops._fill(row, [x0], [q0], [s0], 0)
    assert (one["row0"][0], one["last"][0], one["b"][0], one["nblocks"][0],
            one["flags"][0], row.rows) == (0, 40, 40, 1, table.VEC, 9)


# -------------------------------------------- (b) plain version vs the JAX package
@pytest.mark.parametrize("name", sorted(TREES))
def test_tree_plain_version_bitwise_to_jax(name):
    j_tree, p_tree = _make(name, seed=len(name))
    j_qt = jax.jit(lambda t: j_comp.quantize_tree(t)[0])(j_tree)
    j_spec = jax.tree.map(lambda x: (x.shape, x.dtype), j_tree)   # quantize_tree's
    p_qt, p_spec = p_comp.quantize_tree(p_tree)
    j_pairs = jax.tree.leaves(j_qt, is_leaf=lambda x: isinstance(x, tuple))
    p_pairs = tree.leaves(p_qt, is_leaf=p_comp._is_qs_pair)
    assert len(j_pairs) == len(p_pairs) == len(TREES[name])
    for (jq, js), (pq, ps) in zip(j_pairs, p_pairs):
        _assert_same(pq, jq)
        assert ps.dtype == torch.bfloat16
        _assert_same(ps, js)
    want = jax.jit(lambda qt: j_comp.dequantize_tree(qt, j_spec))(j_qt)
    for back in (p_comp.dequantize_tree(p_qt, p_spec),
                 p_comp.roundtrip_tree(p_tree)):
        for leaf in TREES[name]:
            assert back[leaf].dtype == p_tree[leaf].dtype
            _assert_same(back[leaf], want[leaf])
    # the ref's tree functions are what the CPU path ran
    flat = tree.leaves(p_tree)
    for got, want in zip(q_ref.roundtrip_tree_ref(flat, 256),
                         tree.leaves(p_comp.roundtrip_tree(p_tree))):
        _assert_same(got, want)


def test_dequantize_tree_takes_fp32_scales_and_foreign_pairs():
    """Pairs that are not views of one arena, with fp32 scales, as the JAX
    package's dequantize_last_axis accepts them."""
    j_tree, p_tree = _make("ragged", seed=3)
    j_qt, j_spec = j_comp.quantize_tree(j_tree)
    p_qt, p_spec = p_comp.quantize_tree(p_tree)
    foreign = {k: (q.clone(), s.to(torch.float32)) for k, (q, s) in p_qt.items()}
    got = p_comp.dequantize_tree(foreign, p_spec)
    want = j_comp.dequantize_tree(j_qt, j_spec)
    for k in foreign:
        _assert_same(got[k], want[k])
    with pytest.raises(ValueError):
        p_comp.dequantize_tree({**foreign, "a": (foreign["a"][0][:1],
                                                 foreign["a"][1])}, p_spec)


def test_leaves_on_two_devices_raise():
    with pytest.raises(ValueError, match="devices"):
        q_ops.roundtrip_tree([torch.zeros(3), torch.zeros(3, device="meta")])


# --------------------------------------------------- (c) the row API in bf16
@pytest.mark.parametrize("rows,cols", [(256, 256), (64, 120), (32, 6)])
def test_dequantize_rows_bf16_matches_pallas(rows, cols):
    x = (3.0 * np.random.RandomState(rows * cols).standard_normal(
        (rows, cols))).astype(np.float32)
    jq, js = j_quantize(jnp.asarray(x), block_rows=min(rows, 256), interpret=True)
    want = j_dequantize(jq, js, dtype=jnp.bfloat16, block_rows=min(rows, 256),
                        interpret=True)
    got = q_ops.dequantize_rows(_t(np.asarray(jq)), _t(np.asarray(js)),
                                dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _assert_same(got, want)
    with pytest.raises(TypeError):
        q_ops.dequantize_rows(_t(np.asarray(jq)), _t(np.asarray(js)),
                              dtype=torch.float16)


# ------------------------------------------------------ (d) no CPU launches
def test_cpu_tree_calls_never_launch():
    _, p_tree = _make("many")
    reset_launches()
    qt, spec = p_comp.quantize_tree(p_tree)
    p_comp.dequantize_tree(qt, spec)
    p_comp.roundtrip_tree(p_tree)
    p_comp.quantize_last_axis(p_tree["l03"])
    q_ops.dequantize_rows(*q_ops.quantize_rows(p_tree["l03"]), dtype=torch.bfloat16)
    assert sum(LAUNCHES.values()) == 0
