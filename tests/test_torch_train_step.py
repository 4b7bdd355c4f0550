"""The port's training step held against the JAX package's at smoke size:
``transformer.train_loss`` and one ``train.step.make_train_step`` on
JAX-initialised params carried across with ``repro_torch.convert``, the
same ``TokenPipeline`` batch, for llama3-8b (global attention) and
gemma3-12b (5 local : 1 global, the window inside the sequence); the
naive blocked attention, accumulation microbatches and the remat policies
(remat="dots" saves, a unit, as many products as the JAX unit has
dot_generals without batch dims); the LM receipt (``core.dfl.make_lm_eval_fn``); and checkpoints (the same
manifest as JAX's for one state, a JAX-written chain restored and
extended).

Tolerances (activations are bf16 on both sides, as the JAX train_loss
computes; bf16 rounds at other points in the two frameworks), bounds at
about twice the largest gap measured on the CPU over both archs and both
attention paths: loss within 5e-3 (measured 1.0e-3); grad norm within 5e-3
relative (measured 2.4e-3); each grad leaf, and each leaf's update of an
SGD step at learning rate 1 (the clipped grad itself), within 6e-2
relative L2 (measured 3.0e-2); the AdamW step's update (at step 0 about
-lr * sign(grad)) the same sign as JAX's on at least 90% of each leaf's
elements (a grad within bf16 noise of 0 can take either sign); receipt
accuracy within one token of the validation batch."""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from torch.multiprocessing.reductions import StorageWeakRef     # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode      # noqa: E402

from repro.configs import smoke_config as j_smoke_config        # noqa: E402
from repro.core import dfl as j_dfl                             # noqa: E402
from repro.models import transformer as j_tf                    # noqa: E402
from repro.optim import optimizers as j_opt                     # noqa: E402
from repro.optim import schedules as j_sched                    # noqa: E402
from repro.train import checkpoint as j_ckpt                    # noqa: E402
from repro.train import step as j_step                          # noqa: E402

from repro_torch import convert, tree                           # noqa: E402
from repro_torch.configs import smoke_config                    # noqa: E402
from repro_torch.core import dfl as p_dfl                       # noqa: E402
from repro_torch.data.pipeline import TokenPipeline             # noqa: E402
from repro_torch.models import transformer as p_tf              # noqa: E402
from repro_torch.optim import optimizers as p_opt               # noqa: E402
from repro_torch.optim import schedules as p_sched              # noqa: E402
from repro_torch.train import checkpoint as p_ckpt              # noqa: E402
from repro_torch.train import step as p_step                    # noqa: E402

LOSS_TOL, GNORM_TOL, GRAD_TOL, SIGN_AGREE = 5e-3, 5e-3, 6e-2, 0.9
B, S = 2, 64


def _cfgs(arch, **kw):
    return (dataclasses.replace(j_smoke_config(arch), **kw),
            dataclasses.replace(smoke_config(arch), **kw))


_STATES = {}


def _np_state(arch):
    """The JAX train state of ``smoke_config(arch)`` (PRNGKey 0) as numpy."""
    if arch not in _STATES:
        state, _ = j_step.init_train_state(j_smoke_config(arch), jax.random.PRNGKey(0))
        _STATES[arch] = jax.tree.map(np.asarray, state)
    return _STATES[arch]


def _port_state(np_state):
    return {"params": convert.params_from_jax(np_state["params"], "cpu"),
            "opt": convert.params_from_jax(np_state["opt"], "cpu"),
            "step": torch.tensor(int(np_state["step"]), dtype=torch.int32)}


def _sgd_states(np_state):
    """(JAX state, port state, JAX opt, port opt) for SGD at learning rate 1,
    momentum 0: the update is the clipped grad."""
    jo = j_opt.sgd_momentum(j_sched.constant(1.0), momentum=0.0)
    po = p_opt.sgd_momentum(p_sched.constant(1.0), momentum=0.0)
    j_state = dict(jax.tree.map(jnp.asarray, np_state))
    j_state["opt"] = jo.init(j_state["params"])
    p_state = _port_state(np_state)
    p_state["opt"] = po.init(p_state["params"])
    return j_state, p_state, jo, po


def _batch(seed=0):
    b = TokenPipeline(256, B, S).batch_at(seed)
    return ({k: jnp.asarray(v) for k, v in b.items()},
            {k: torch.as_tensor(v) for k, v in b.items()})


def _rel_l2(got, want):
    want = np.asarray(want)
    return float(np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want))


def _updates(new, old):
    return [np.asarray(n) - np.asarray(o) for n, o in zip(new, old)]


@pytest.mark.parametrize("arch,impl", [("llama3-8b", "flash"), ("gemma3-12b", "flash"),
                                       ("llama3-8b", "naive")])
def test_train_step_matches_jax(arch, impl):
    jcfg, pcfg = _cfgs(arch, attn_impl=impl)
    np_state = _np_state(arch)
    jb, pb = _batch()
    j_state = jax.tree.map(jnp.asarray, np_state)
    old = jax.tree.leaves(np_state["params"])

    j_sgd, p_sgd, jo, po = _sgd_states(np_state)
    j_new, j_met = jax.jit(j_step.make_train_step(jcfg, jo))(j_sgd, jb)
    p_new, p_met = p_step.make_train_step(pcfg, po)(p_sgd, pb)
    assert set(p_met) == {"loss", "accuracy", "aux", "grad_norm"}
    assert abs(float(p_met["loss"]) - float(j_met["loss"])) <= LOSS_TOL
    assert abs(float(p_met["grad_norm"]) / float(j_met["grad_norm"]) - 1) <= GNORM_TOL
    assert float(p_met["aux"]) == 0.0 and int(p_new["step"]) == 1
    gaps = [_rel_l2(p, j) for p, j in zip(
        _updates(tree.leaves(convert.params_to_numpy(p_new["params"])), old),
        _updates(jax.tree.leaves(j_new["params"]), old))]
    assert max(gaps) <= GRAD_TOL, gaps

    # the default step (AdamW, warmup-cosine): same metrics, update signs
    j_new, j_met = jax.jit(j_step.make_train_step(jcfg))(j_state, jb)
    p_new, p_met = p_step.make_train_step(pcfg)(_port_state(np_state), pb)
    assert abs(float(p_met["loss"]) - float(j_met["loss"])) <= LOSS_TOL
    for p, j in zip(_updates(tree.leaves(convert.params_to_numpy(p_new["params"])), old),
                    _updates(jax.tree.leaves(j_new["params"]), old)):
        assert np.mean(np.sign(p) == np.sign(j)) >= SIGN_AGREE
    for p, j in zip(tree.leaves(convert.params_to_numpy(p_new["opt"])),
                    jax.tree.leaves(j_new["opt"])):
        assert p.shape == j.shape and p.dtype == j.dtype


def _jax_unit_dots_without_batch_dims(cfg, batch):
    """The dot_generals with no batch dims inside the JAX loss's remat
    (one scanned unit), nested calls and scans included."""
    def subs(e):
        for v in e.params.values():
            for x in (v if isinstance(v, (list, tuple)) else (v,)):
                if hasattr(x, "eqns"):
                    yield x
                elif hasattr(getattr(x, "jaxpr", None), "eqns"):
                    yield x.jaxpr

    def dots(j):
        return sum((e.primitive.name == "dot_general"
                    and not e.params["dimension_numbers"][1][0])
                   + sum(dots(x) for x in subs(e)) for e in j.eqns)

    def remats(j):
        for e in j.eqns:
            if e.primitive.name in ("checkpoint", "remat2"):
                yield e
            else:
                for x in subs(e):
                    yield from remats(x)

    params, _ = j_tf.init(jax.random.PRNGKey(0), cfg)
    jx = jax.make_jaxpr(lambda p: j_tf.train_loss(p, cfg, batch)[0])(params)
    (unit,) = remats(jx.jaxpr)
    return sum(dots(x) for x in subs(unit))


class _ProductOutputs(TorchDispatchMode):
    """Records a weak reference to the storage of every matrix product's
    output dispatched while it is on."""

    OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
           torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)

    def __init__(self):
        super().__init__()
        self.refs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in self.OPS:
            self.refs.append(StorageWeakRef(out.untyped_storage()))
        return out


@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b"])
def test_remat_dots_saves_the_products_without_batch_dims(arch):
    """Under remat="dots" the forward leaves alive, a unit, as many matrix
    product outputs as the JAX unit has dot_generals without batch dims
    (its policy's saveables: the dense projections and the MoE router;
    attention's and the experts' batched einsums are recomputed), and under
    "full" none. A saved-tensors hook outside the units sees the same
    tensors under both policies: checkpoint's own hooks hold the unit's
    boundary, and the policy's saves live in the checkpoint's cache, which
    is why the products are counted by their storages staying alive."""
    jcfg, _ = _cfgs(arch, remat="dots")
    jb, pb = _batch(5)
    want = _jax_unit_dots_without_batch_dims(jcfg, jb)
    alive, packed = {}, {}
    for remat in ("full", "dots"):
        _, pcfg = _cfgs(arch, remat=remat)
        params = p_tf.init(torch.Generator().manual_seed(0), pcfg, "cpu")
        leaves = [x.requires_grad_() for x in tree.leaves(params)]
        rec, n = _ProductOutputs(), [0]

        def pack(t):
            n[0] += 1
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t), rec:
            loss, _ = p_tf.train_loss(params, pcfg, pb)
        alive[remat] = sum(not r.expired() for r in rec.refs)
        packed[remat] = n[0]
        torch.autograd.grad(loss, leaves, allow_unused=True)
    n_units = p_tf.unit_layout(pcfg)[0]
    assert alive["full"] == 0
    assert alive["dots"] == want * n_units, (alive, want, n_units)
    assert packed["dots"] == packed["full"]


@pytest.mark.parametrize("eq,shapes,saved", [
    ("bsd,df->bsf", ((2, 5, 8), (8, 6)), 1),     # no batch dims: bmm over 1
    ("bqd,bkd->bqk", ((2, 5, 8), (2, 7, 8)), 0),  # batch dim b: bmm over 2
])
def test_remat_dots_policy_reads_the_operands(eq, shapes, saved):
    """``torch.einsum`` lowers a contraction without batch dims to a bmm over
    a batch of 1: the dots policy saves it as JAX saves the dot_general,
    and recomputes a batched one."""
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts
    g = torch.Generator().manual_seed(0)
    x, w = (torch.randn(s, generator=g, requires_grad=True) for s in shapes)
    rec = _ProductOutputs()
    with rec:
        y = checkpoint(lambda a, b: torch.einsum(eq, a, b).tanh(), x, w,
                       use_reentrant=False,
                       context_fn=lambda: create_selective_checkpoint_contexts(
                           p_tf.dots_policy))
    assert sum(not r.expired() for r in rec.refs) == saved
    y.sum().backward()


def test_remat_policies_and_accumulation():
    """remat "full" (checkpointed units and loss chunks) and "dots" (saved
    dense products, the rest recomputed) give the same bits as "none", and
    "dots" is within the step tolerances of JAX's remat="dots" loss and
    grads; two accumulation microbatches against JAX's scan over them."""
    np_state = _np_state("llama3-8b")
    jb, pb = _batch(3)
    runs = {}
    for remat in ("full", "none", "dots"):
        _, pcfg = _cfgs("llama3-8b", remat=remat)
        runs[remat] = p_step.loss_and_grads(_port_state(np_state)["params"], pcfg, pb)
    for remat in ("none", "dots"):
        for a, b in zip(tree.leaves(runs["full"][2]), tree.leaves(runs[remat][2])):
            assert torch.equal(a, b)
        assert torch.equal(runs["full"][0], runs[remat][0])
    jcfg, _ = _cfgs("llama3-8b", remat="dots")
    (j_loss, _), j_grads = jax.value_and_grad(
        lambda p: j_tf.train_loss(p, jcfg, jb), has_aux=True)(
            jax.tree.map(jnp.asarray, np_state["params"]))
    assert abs(float(runs["dots"][0]) - float(j_loss)) <= LOSS_TOL
    gaps = [_rel_l2(p, j) for p, j in zip(
        tree.leaves(convert.params_to_numpy(runs["dots"][2])), jax.tree.leaves(j_grads))]
    assert max(gaps) <= GRAD_TOL, gaps

    jcfg, pcfg = _cfgs("llama3-8b", accum_steps=2)
    jb, pb = _batch(4)
    j_sgd, p_sgd, jo, po = _sgd_states(np_state)
    j_new, j_met = jax.jit(j_step.make_train_step(jcfg, jo))(j_sgd, jb)
    p_new, p_met = p_step.make_train_step(pcfg, po)(p_sgd, pb)
    assert abs(float(p_met["loss"]) - float(j_met["loss"])) <= LOSS_TOL
    old = jax.tree.leaves(np_state["params"])
    gaps = [_rel_l2(p, j) for p, j in zip(
        _updates(tree.leaves(convert.params_to_numpy(p_new["params"])), old),
        _updates(jax.tree.leaves(j_new["params"]), old))]
    assert max(gaps) <= GRAD_TOL, gaps


@pytest.mark.parametrize("arch", ["llama3-8b", "gemma3-12b"])
def test_lm_receipt_matches_jax(arch):
    jcfg, pcfg = _cfgs(arch)
    np_state = _np_state(arch)
    vb = TokenPipeline(256, 2, 64, fed_nodes=2).batch_at(10_000, node=1)
    want = float(j_dfl.make_lm_eval_fn(jcfg)(
        jax.tree.map(jnp.asarray, np_state["params"]),
        {k: jnp.asarray(v) for k, v in vb.items()}))
    params = convert.params_from_jax(np_state["params"], "cpu")
    got = p_dfl.make_lm_eval_fn(pcfg)(params, {k: torch.as_tensor(v)
                                               for k, v in vb.items()})
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1.0 / vb["labels"].size
    _, loss_metrics = p_tf.train_loss(params, pcfg, {k: torch.as_tensor(v)
                                                    for k, v in vb.items()})
    assert float(loss_metrics["accuracy"]) == float(got)


def _fed_like(np_state, f):
    return jax.tree.map(lambda x: np.stack([x] * f), np_state)


def test_checkpoint_manifests_equal_jax(tmp_path):
    """The same state saved by both packages: identical manifests (keys,
    shapes, dtypes, sha256 digests, the chain digests), a federation state
    (F, ...) included."""
    np_state = _np_state("llama3-8b")
    for name, state in (("plain", np_state), ("fed", _fed_like(np_state, 3))):
        jd, pd = tmp_path / f"j_{name}", tmp_path / f"p_{name}"
        for step in (3, 6):
            j_digest = j_ckpt.save(str(jd), jax.tree.map(jnp.asarray, state), step,
                                   arch="llama3-8b", extra={"fed": 3})
            p_digest = p_ckpt.save(str(pd), _port_state(state) if name == "plain"
                                   else convert.params_from_jax(state, "cpu"), step,
                                   arch="llama3-8b", extra={"fed": 3})
            assert p_digest == j_digest
            j_m = json.loads((jd / f"step_{step:08d}" / "manifest.json").read_text())
            p_m = json.loads((pd / f"step_{step:08d}" / "manifest.json").read_text())
            assert p_m == j_m
        assert p_ckpt.verify_chain(str(pd)) and j_ckpt.verify_chain(str(pd))


def test_port_restores_and_extends_a_jax_chain(tmp_path):
    np_state = _np_state("gemma3-12b")
    d = str(tmp_path / "chain")
    j_state = jax.tree.map(jnp.asarray, np_state)
    for step in (2, 4):
        j_state = dict(j_state, step=jnp.asarray(step, jnp.int32))
        j_ckpt.save(d, j_state, step, arch="gemma3-12b")
    like = _port_state(np_state)
    assert p_ckpt.verify_chain(d)
    got, step = p_ckpt.restore(d, like)
    assert step == 4 and int(got["step"]) == 4
    for a, b in zip(tree.leaves(convert.params_to_numpy(got)),
                    jax.tree.leaves(dict(np_state, step=np.int32(4)))):
        assert np.array_equal(a, b)
    got2, step2 = p_ckpt.restore(d, like, step=2)
    assert step2 == 2 and int(got2["step"]) == 2
    p_ckpt.save(d, got, 6, arch="gemma3-12b")
    assert j_ckpt.verify_chain(d) and p_ckpt.latest_manifest(d)["step"] == 6
    p_ckpt.prune(d, keep=1)
    assert [m["step"] for _, m in p_ckpt._manifests(d)] == [6]
    # a flipped byte is caught before any state is handed back
    arrays = dict(np.load(f"{d}/step_00000006/shard-0.npz"))
    key = "params/final_norm/scale"
    arrays[key] = arrays[key] + 1.0
    np.savez(f"{d}/step_00000006/shard-0.npz", **arrays)
    with pytest.raises(ValueError, match="corruption"):
        p_ckpt.restore(d, like)


@pytest.mark.parametrize("kwargs,fed", [({}, 4), ({"topology": "kregular", "ttl": 2}, 8),
                                        ({"topology": "erdos", "ttl": 2}, 8)])
def test_dfl_config_and_schedule_report_match_jax(kwargs, fed):
    assert dataclasses.asdict(p_dfl.DFLConfig()) == dataclasses.asdict(j_dfl.DFLConfig())
    assert (p_dfl.schedule_report(p_dfl.DFLConfig(**kwargs), fed)
            == j_dfl.schedule_report(j_dfl.DFLConfig(**kwargs), fed))
    # the chain oracle under-covers an irregular graph's ttl-ball: both raise
    if kwargs.get("topology") == "erdos":
        for lib in (p_dfl, j_dfl):
            with pytest.raises(RuntimeError, match="under-covers"):
                lib.schedule_report(lib.DFLConfig(**kwargs, schedule="chain"), fed)
    cfg = smoke_config("llama3-8b")
    want = j_dfl.val_batch_specs(j_smoke_config("llama3-8b"), j_dfl.DFLConfig(), fed)
    got = p_dfl.val_batch_specs(cfg, p_dfl.DFLConfig(), fed)
    assert {k: v[0] for k, v in got.items()} == {k: tuple(v.shape) for k, v in want.items()}
    state, rep = p_dfl.init_federation(cfg, fed, torch.Generator().manual_seed(1),
                                       device="cpu")
    assert rep.shape == (fed,) and bool((rep == 1).all()) and int(state["step"]) == 0
    assert set(state["opt"]) == {"m", "v"}
