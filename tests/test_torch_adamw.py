"""The clip and AdamW wrappers (``repro_torch.kernels.adamw``) off the card.

CPU tensors take the plain version and launch nothing; ``Optimizer.apply``
is the clip, ``update`` and ``apply_updates`` it stands for, bitwise on the
CPU, for every optimizer; the meta branch (the dry-run cell report's trace)
reports the kernels' bytes, 32 a parameter, and allocates nothing but the
partial sums' scratch and the norm's result. The kernels themselves are held to the plain
version on the card in ``test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch import kernels, tree                        # noqa: E402
from repro_torch.kernels.adamw import ops, ref                # noqa: E402
from repro_torch.launch import op_cost                        # noqa: E402
from repro_torch.optim import optimizers as opt_lib           # noqa: E402
from repro_torch.optim import schedules                       # noqa: E402

HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)
# numels not a multiple of 4, one element, an empty leaf, a 2-block leaf
SHAPES = [(6, 5), (7,), (2, 3, 4), (1,), (0, 3), (1030,)]


def _boom(*a, **k):
    raise AssertionError("reached a route this device must not take")


def _tree(gen, scale=1.0, device="cpu"):
    return {f"l{i}": (scale * torch.randn(s, generator=gen)).to(device)
            for i, s in enumerate(SHAPES)}


def _clone(x):
    return tree.map(torch.clone, x)


def _lr():
    return schedules.warmup_cosine(1e-2, 2, 10)


def test_sumsq_blocks():
    assert [ops.sumsq_blocks(n) for n in (0, 1, 1024, 1025, 4 * 1024 * 1024)] == \
        [0, 1, 1, 2, ops.SUMSQ_BLOCKS]


@pytest.mark.parametrize("step", [0, 3])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(monkeypatch, step):
    monkeypatch.setattr(kernels.build, "load", _boom)
    kernels.reset_launches()
    g = torch.Generator().manual_seed(step)
    grads = list(_tree(g, scale=3.0).values())
    norm, scale = ops.grad_norm(grads, 1.0)
    want_norm, want_scale = ref.grad_norm(grads, 1.0)
    assert torch.equal(norm, want_norm) and torch.equal(scale, want_scale)
    assert float(scale) < 1.0                       # the clip engages
    lr = _lr()(step)
    t = torch.tensor(float(step)) + 1.0
    bc1, bc2 = 1.0 - HP["b1"] ** t, 1.0 - HP["b2"] ** t
    for x in grads:
        m, v, p = torch.randn(x.shape, generator=g).abs(), torch.rand(x.shape, generator=g), \
            torch.randn(x.shape, generator=g)
        want = [t_.clone() for t_ in (x, m, v, p)]
        g0 = x.clone()
        out = ops.adamw_step(x, m, v, p, scale, lr, bc1, bc2, **HP)
        ref.adamw_step(*want, scale, lr, bc1, bc2, **HP)
        assert out is p
        assert torch.equal(x, g0)                   # g left as the kernel leaves it
        for a, b in zip((x, m, v, p), want):
            assert torch.equal(a, b)
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("name", ["adamw", "sgdm", "adafactor"])
def test_apply_is_clip_update_and_apply_updates(name):
    """Three steps of ``apply`` against the three calls it stands for, the
    clip engaged on the second: params, state and norm bitwise."""
    opt = opt_lib.make_optimizer(name, _lr())
    g = torch.Generator().manual_seed(1)
    params = _tree(g)
    a_params, b_params = _clone(params), _clone(params)
    a_state, b_state = opt.init(a_params), opt.init(b_params)
    for step in range(3):
        grads = _tree(g, scale=3.0 if step == 1 else 0.01)
        s = torch.tensor(step, dtype=torch.int32)
        a_grads = _clone(grads)
        a_params, a_state, a_norm = opt.apply(a_grads, a_state, a_params, s, 1.0)
        if name == "adamw":                         # the kernels' contract: g kept
            for a, b in zip(tree.leaves(a_grads), tree.leaves(grads)):
                assert torch.equal(a, b)
        clipped, b_norm = opt_lib.clip_by_global_norm(_clone(grads), 1.0)
        upd, b_state = opt.update(clipped, b_state, b_params, s)
        b_params = opt_lib.apply_updates(b_params, upd)
        assert torch.equal(a_norm, b_norm)
        for a, b in zip(tree.leaves((a_params, a_state)), tree.leaves((b_params, b_state))):
            # exact; adafactor's factored moments of the empty leaf are NaN
            torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True,
                                       msg=f"{name} step {step}")
    assert float(a_norm) > 0


def _meta_state(opt):
    params = {f"l{i}": torch.empty(s, device="meta") for i, s in enumerate(SHAPES)}
    grads = tree.map(torch.empty_like, params)
    return params, grads, opt.init(params), torch.zeros((), dtype=torch.int32,
                                                        device="meta")


def test_meta_branch_reports_32_bytes_a_parameter_and_allocates_only_the_scratch(
        monkeypatch):
    opt = opt_lib.make_optimizer("adamw", _lr())
    params, grads, state, step = _meta_state(opt)
    # what the plain version keeps alive at once: two leaf-sized temporaries
    with op_cost.OpCost(known=(params, grads, state)) as plain:
        opt_lib._composed_apply(opt.update)(grads, state, params, step, 1.0)
    largest = max(x.numel() for x in tree.leaves(params)) * 4
    assert plain.peak_live >= 2 * largest

    for name in ("adamw_update", "adamw_step", "grad_norm"):
        monkeypatch.setattr(ref, name, _boom)
    monkeypatch.setattr(opt_lib, "global_norm", _boom)
    monkeypatch.setattr(kernels.build, "load", _boom)
    kernels.reset_launches()
    with op_cost.OpCost(known=(params, grads, state)) as w:
        out, new_state, norm = opt.apply(grads, state, params, step, 1.0)
    numels = [x.numel() for x in tree.leaves(params)]
    P, L = sum(numels), sum(n > 0 for n in numels)
    total = sum(ops.sumsq_blocks(n) for n in numels)
    scratch = 4 * total + 8                             # the partials, the result
    assert w.by_op["kernel:adamw_step"][2] == 28 * P
    assert w.by_op["kernel:grad_sumsq"][2] == 4 * P + 8      # g read, norm and scale
    assert w.kernel_calls == {"adamw_step": L, "grad_sumsq": L + 1}
    assert w.by_op["kernel:grad_sumsq"][1] == P        # a FLOP a summed element
    # the scratch and the schedule's 0-d scalars: nothing a leaf's size
    assert scratch <= w.peak_live <= scratch + 64 * 4
    assert out is params and new_state is state and norm.is_meta and norm.shape == ()
    assert not kernels.LAUNCHES


@pytest.mark.parametrize("fault", ["bf16_p", "bf16_grad", "strided_m", "scale_2",
                                   "lr_elsewhere"])
def test_meta_branch_raises_on_what_the_kernels_do_not_take(fault):
    """The meta branch checks what the card's does (the card's own raises:
    ``test_torch_cuda.py``)."""
    x = lambda *s, **k: torch.zeros(s or (4, 6), device="meta", **k)  # noqa: E731
    g, m, v, p, s = x(), x(), x(), x(), x(1)
    if fault == "bf16_p":
        p = x(dtype=torch.bfloat16)
    elif fault == "bf16_grad":
        with pytest.raises(TypeError):
            ops.grad_norm([x(), x(dtype=torch.bfloat16)], 1.0)
        return
    elif fault == "strided_m":
        m = x(6, 4).t()
    elif fault == "scale_2":
        s = x(2)
    err = TypeError if fault.startswith("bf16") else ValueError
    lr = torch.zeros(()) if fault == "lr_elsewhere" else s
    with pytest.raises(err):
        ops.adamw_step(g, m, v, p, s, lr, s, s, **HP)
