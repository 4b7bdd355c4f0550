"""How much memory the port's ``transformer.init`` holds at once, at every
arch's published config, traced on the meta device under the op-cost
walker (``launch.op_cost.OpCost``: bytes of every storage alive at once,
which phase 18b of chip_smoke matched to the card's allocator to 1.5e-7).

``init`` allocates each stacked leaf once, in the dtype it is stored in,
and fills it one unit slice (an MoE expert stack one (unit, expert) slice)
at a time, each drawn in fp32 and cast into place. So the peak is the
params W plus at most one fp32 draw: a leaf's slice, or an embedding or
position table drawn whole while little else is alive. Bound (the
contract of the serving entry point's bf16 build): the peak within 4 GiB
of W for every arch, command-r-35b's 40 layers within 60.5 GiB (one H100
holds 80 GB); and at most the largest fp32 draw above W, in bf16 and in
fp32 (the training path's build).

Also: ``layers.draw_stacked``'s slice order and cast, and the serving
entry point on the meta device (what chip_smoke's phase 15b traces to
predict each arch's peak)."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch import serve, tree                             # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.launch.op_cost import OpCost                   # noqa: E402
from repro_torch.models import layers as L                      # noqa: E402
from repro_torch.models import moe as moe_lib                   # noqa: E402
from repro_torch.models import transformer                      # noqa: E402

GiB = 2**30
EXCESS_LIMIT = 4 * GiB
COMMAND_R_LIMIT = 60.5 * GiB


def _nbytes(params):
    return sum(t.numel() * t.element_size() for t in tree.leaves(params))


def _largest_fp32_draw(params, cfg):
    """Bytes of the largest tensor ``init`` draws in fp32: one unit's slice
    of a stacked leaf (one expert's of an expert stack), a trailing layer's
    leaf, or a table."""
    n_units = transformer.unit_layout(cfg)[0]
    sizes = []

    def walk(t, path, stacked):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, (*path, k), stacked)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v, path, stacked)
        else:
            n = t.numel() // (n_units if stacked else 1)
            if path[-1] in moe_lib.EXPERT_STACKS and len(path) > 1 and path[-2] == "ffn":
                n //= cfg.moe.num_experts
            sizes.append(4 * n)

    for key, sub in params.items():
        walk(sub, (key,), key == "units")
    return max(sizes)


def _traced_init(cfg, dtype):
    with OpCost() as walker:
        params = transformer.init(torch.Generator(), cfg, "meta", dtype=dtype)
    return params, walker.peak_live


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_bf16_init_peaks_one_draw_above_the_weights(arch):
    cfg = get_config(arch)
    params, peak = _traced_init(cfg, torch.bfloat16)
    W = _nbytes(params)
    assert transformer.param_count(params) == sum(t.numel() for t in tree.leaves(params))
    assert peak - W <= EXCESS_LIMIT, (arch, peak / GiB, W / GiB)
    assert peak - W <= _largest_fp32_draw(params, cfg), (arch, peak / GiB, W / GiB)
    if arch == "command-r-35b":
        assert cfg.num_layers == 40 and peak <= COMMAND_R_LIMIT, peak / GiB


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_fp32_init_peaks_one_draw_above_the_weights(arch):
    cfg = get_config(arch)
    params, peak = _traced_init(cfg, None)
    assert all(t.dtype == torch.float32 for t in tree.leaves(params))
    W = _nbytes(params)
    assert peak - W <= _largest_fp32_draw(params, cfg), (arch, peak / GiB, W / GiB)


@pytest.mark.parametrize("lead", [(), (3,), (2, 3)])
def test_draw_stacked_fills_slices_in_order_and_casts_them(lead):
    shape = (5, 7)

    def leaf(dtype):
        g = torch.Generator().manual_seed(11)
        return L.draw_stacked(lead, shape, lambda: torch.randn(shape, generator=g),
                              "cpu", dtype)

    g = torch.Generator().manual_seed(11)
    slices = [torch.randn(shape, generator=g) for _ in range(math.prod(lead))]
    want = torch.stack(slices).reshape(*lead, *shape)
    got = leaf(None)
    assert got.dtype == torch.float32 and torch.equal(got, want)
    got16 = leaf(torch.bfloat16)
    assert got16.dtype == torch.bfloat16 and torch.equal(got16, want.to(torch.bfloat16))


def test_expert_stacks_are_drawn_one_unit_and_expert_at_a_time():
    """An MoE layer's expert stack (units, E, d, ff): each (unit, expert)
    matrix is one fp32 draw, so its entries follow the truncated normal of
    one expert (|x| <= 2 / sqrt(fan_in)) and differ between slices."""
    cfg = smoke_config("dbrx-132b")
    p = moe_lib.moe_init(torch.Generator().manual_seed(2), cfg, "cpu", lead=(2,),
                         dtype=torch.bfloat16)
    E, d = cfg.moe.num_experts, cfg.d_model
    gate = p["gate"]
    assert gate.shape == (2, E, d, cfg.moe.d_ff_expert) and gate.dtype == torch.bfloat16
    assert float(gate.float().abs().max()) <= 2 / math.sqrt(d) * (1 + 2**-8)
    flat = gate.float().reshape(2 * E, -1).numpy()
    assert len({row.tobytes() for row in flat}) == 2 * E
    assert np.all(flat.std(axis=1) > 0)


@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b", "hubert-xlarge"])
def test_serve_runs_on_the_meta_device(arch):
    """``serve.serve(..., "meta")``: shapes only, nothing allocated, the
    weights in the dtypes of the card's build."""
    cfg = smoke_config(arch)
    with OpCost() as walker:
        out = serve.serve(cfg, 2, 24, 3, "meta")
    assert walker.peak_live > _nbytes(out["weights"])
    assert all(t.device.type == "meta" for t in tree.leaves(out["weights"]))
    assert out["logits"].device.type == "meta"
    assert out["logits"].shape == (2, cfg.vocab_size)
    if cfg.supports_decode:
        assert out["tokens"].shape == (2, 3)
    else:
        assert out["tokens"] is None
    cpu = transformer.init(torch.Generator().manual_seed(0), cfg, "cpu", dtype=serve.DTYPE)
    assert [(t.shape, t.dtype) for t in tree.leaves(out["weights"])] == \
        [(t.shape, t.dtype) for t in tree.leaves(cpu)]
