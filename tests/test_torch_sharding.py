"""The port's sharding rules and logical-axes trees (``repro_torch.sharding``,
``transformer.param_axes`` / ``cache_axes``, ``train.step``'s abstract
helpers) held to the JAX package's on the CPU.

Both packages resolve the same logical axes against the same stand-in
meshes (names and sizes only), so specs must be equal, entry for entry.
The axes trees are compared leaf by leaf in ``jax.tree.leaves`` order
(the port's ``tree.leaves`` visits dict keys in the same sorted order), at
every arch's full config: the port builds its trees on the meta device,
JAX with ``jax.eval_shape``; neither allocates."""
import itertools

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")

from repro import sharding as jsh                           # noqa: E402
from repro.configs import get_config as jax_config          # noqa: E402
from repro.train import step as jstep                       # noqa: E402
from repro_torch import sharding as sh                      # noqa: E402
from repro_torch import tree                                # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.launch import mesh as mesh_lib             # noqa: E402
from repro_torch.train import step                          # noqa: E402


class FakeMesh:
    def __init__(self, shape):  # dict axis -> size
        self.shape = shape
        self.axis_names = tuple(shape)


MESHES = {"2x2": {"data": 2, "model": 2}, "16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "fed2x1x2": {"fed": 2, "data": 1, "model": 2}}
AXES = [
    ("batch", "seq"), ("batch", None, "kv_heads", "head_dim"),
    ("stack", "embed", "heads", "head_dim"), ("vocab", "embed"),
    ("experts", "embed", "ffn"), ("batch", "kv_seq", "kv_heads", "head_dim"),
    ("ffn", "ffn"), ("rnn", "rnn"), ("fed", "stack", "embed", "ffn"),
    ("batch", "heads", None, None), ("embed",), (), ("conv", "rnn"),
]
DIMS = [1, 2, 3, 8, 16, 24, 32, 128, 4096]
RULES = {"default": dict(fsdp=False), "fsdp": dict(fsdp=True),
         "long": dict(shard_kv_seq=True)}


def _is_axes(x):
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def _jax_leaves(t):
    return [tuple(a) for a in jax.tree.leaves(t, is_leaf=_is_axes)]


def _shapes(n):
    """About 30 shapes of ``n`` dims from DIMS, divisible and not."""
    combos = list(itertools.product(DIMS, repeat=n))
    return combos[::max(1, len(combos) // 30)]


@pytest.mark.parametrize("rules_name", sorted(RULES))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_logical_to_spec_matches_jax(mesh_name, rules_name):
    mesh = FakeMesh(MESHES[mesh_name])
    p_rules = sh.make_rules(**RULES[rules_name])
    j_rules = jsh.make_rules(**RULES[rules_name])
    decode = dict(p_rules, kv_seq=(("data",), ("model",)))
    checked = 0
    for axes in AXES:
        for shape in _shapes(len(axes)):
            for pr, jr in ((p_rules, j_rules),
                           (decode, dict(j_rules, kv_seq=(("data",), ("model",))))):
                got = sh.logical_to_spec(axes, mesh, pr, shape)
                want = tuple(jsh.logical_to_spec(axes, mesh, jr, shape))
                assert got == want, (axes, shape, got, want)
                checked += 1
    assert checked > 300


def test_axis_used_once_and_divisibility():
    mesh = FakeMesh({"data": 16, "model": 16})
    rules = sh.make_rules()
    # kv_heads=8 cannot shard over model=16
    assert sh.logical_to_spec(("batch", None, "kv_heads", "head_dim"), mesh, rules,
                              (128, 32, 8, 128)) == ("data",)
    # the second ffn dim cannot take model again
    assert sh.logical_to_spec(("ffn", "ffn"), mesh, rules, (64, 64)) == ("model",)
    multi = FakeMesh({"pod": 2, "data": 16, "model": 16})
    spec = sh.logical_to_spec(("batch", "seq"), multi, rules, (64, 8))
    assert spec == (("pod", "data"),)
    assert sh.shard_factor(spec, multi) == 32
    assert sh.shard_factor(("data", None, "model"), mesh) == 256
    assert sh.shard_factor((), mesh) == 1


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_axes_match_jax_abstract_params(arch):
    cfg = get_config(arch)
    params, axes = step.abstract_params(cfg)
    jparams, jaxes = jstep.abstract_params(jax_config(arch))
    got = tree.leaves(axes, is_leaf=sh.is_axes)
    assert got == _jax_leaves(jaxes)
    leaves = tree.leaves(params)
    assert [tuple(x.shape) for x in leaves] == [tuple(x.shape)
                                                for x in jax.tree.leaves(jparams)]
    assert all(x.is_meta and x.dim() == len(a) for x, a in zip(leaves, got))
    # AdamW's state mirrors the params
    o_axes = step.opt_state_axes(cfg.optimizer, axes, params)
    j_o = jstep.opt_state_axes(cfg.optimizer, jaxes, jparams)
    assert tree.leaves(o_axes, is_leaf=sh.is_axes) == _jax_leaves(j_o)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_axes_match_jax_abstract_cache(arch):
    cfg = get_config(arch)
    cache, axes = step.abstract_cache(cfg, 4, 256)
    jcache, jaxes = jstep.abstract_cache(jax_config(arch), 4, 256)
    got = [a for a in tree.leaves(axes, is_leaf=sh.is_axes) if a is not None]
    assert got == _jax_leaves(jaxes)
    assert [tuple(x.shape) for x in tree.leaves(cache) if x is not None] == [
        tuple(x.shape) for x in jax.tree.leaves(jcache)]


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
def test_input_specs_and_batch_specs_match_jax(shape_name):
    shape = SHAPES[shape_name]
    mesh = FakeMesh(MESHES["16x16"])
    for arch in ("llama3-8b", "hubert-xlarge", "llava-next-mistral-7b"):
        cfg = get_config(arch)
        batch = step.input_specs(cfg, shape)
        jbatch = jstep.input_specs(jax_config(arch), shape)
        assert sorted(batch) == sorted(jbatch)
        for k in batch:
            assert tuple(batch[k].shape) == tuple(jbatch[k].shape), (arch, k)
            assert str(batch[k].dtype).split(".")[-1] == str(jbatch[k].dtype), k
        rules = step.rules_for(cfg, shape)
        jrules = jstep.rules_for(jax_config(arch), shape)
        specs = step.batch_shardings(cfg, shape, batch, mesh, rules)
        jspecs = {k: tuple(jsh.logical_to_spec(a, mesh, jrules, jbatch[k].shape))
                  for k, a in jstep.batch_axes(jax_config(arch), shape).items()}
        assert specs == jspecs, arch


def test_abstract_meshes_name_the_production_meshes():
    single = mesh_lib.abstract_production_mesh()
    multi = mesh_lib.abstract_production_mesh(multi_pod=True)
    assert (single.describe(), single.size, single.shape) == (
        "16x16", 256, {"data": 16, "model": 16})
    assert (multi.describe(), multi.size) == ("2x16x16", 512)
    assert mesh_lib.fed_axis_name(multi) == "pod"
    assert mesh_lib.fed_axis_name(single) == "data"
    fed = mesh_lib.abstract_fed_mesh(4, 2, 2)
    assert (mesh_lib.fed_axis_name(fed), fed.shape["fed"]) == ("fed", 4)
    assert mesh_lib.abstract_test_mesh().describe() == "2x2"


def test_train_state_specs_divide_each_leaf():
    cfg = get_config("llama3-8b")
    state, axes = step.abstract_train_state(cfg)
    mesh = mesh_lib.abstract_production_mesh()
    specs = step.state_shardings(state, axes, mesh,
                                 step.rules_for(cfg, SHAPES["train_4k"]))
    assert cfg.fsdp                   # d_model over data (ZeRO-3)
    table = specs["params"]["embed"]["table"]
    assert table == ("model", "data")  # vocab 128256 over model 16
    assert specs["opt"]["m"]["embed"]["table"] == table
    assert specs["step"] == ()
    # (stack, embed, kv_heads, head_dim): kv heads 8 do not split over 16
    assert specs["params"]["units"][0]["mix"]["k"]["w"] == (None, "data")


def test_activation_context_is_a_no_op():
    x = torch.ones(3)
    with sh.activation_sharding(FakeMesh(MESHES["2x2"]), sh.make_rules()):
        assert sh.maybe_shard(x, ("batch",)) is x
    with sh.no_activation_sharding():
        assert sh.maybe_shard(x, (None,)) is x
