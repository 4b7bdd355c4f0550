"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(a CUDA kernel has no CPU or interpret mode; the CPU tests hold the plain
versions to the JAX package). Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# every LeNet leaf's last-axis blocking (the biases one row each), a flat
# payload in 256-column rows (f1.w's 94 080 elements padded: 368 rows),
# ragged row counts and a ragged 77-column cut
@pytest.mark.parametrize("shape", [(1, 6), (25, 6), (1, 16), (150, 16), (1, 120),
                                   (784, 120), (1, 84), (120, 84), (1, 10), (84, 10),
                                   (368, 256), (1001, 256), (1001, 77), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pair_bitwise_vs_plain(cuda, shape, dtype):
    """The row API bitwise its plain version; from 9 rows on, an all-zero
    row, a tiny one (under the scale's epsilon) and a row of .5 ties, which
    round half to even."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    g = torch.Generator().manual_seed(shape[0] * shape[1])
    x = torch.randn(shape, generator=g) * 3.0
    ties = shape[0] >= 9 and shape[1] >= 6
    if ties:
        x[5] = 0.0
        x[6] = 1e-30 * x[7]
        x[8] = 0.0
        x[8, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    x = x.to(cuda, getattr(torch, dtype))
    reset_launches()
    q, s = ops.quantize_rows(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(ops.dequantize_rows(q, s), dequantize_ref(q, s))
    torch.cuda.synchronize()
    assert LAUNCHES["quantize"] == 1 and LAUNCHES["dequantize"] == 1
    if ties:
        assert q[8, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("shape", [(784, 120), (1001, 256), (3, 1), (64, 6)])
@pytest.mark.parametrize("scale_dtype", ["float32", "bfloat16"])
def test_dequantize_rows_bf16_out_bitwise_vs_plain(cuda, shape, scale_dtype):
    """The Pallas dequantize's dtype= argument: the fp32 product rounded
    once to bf16, from fp32 or bf16 scales."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize.ref import dequantize_ref
    g = torch.Generator().manual_seed(shape[0] + shape[1])
    x = (torch.randn(shape, generator=g) * 3.0).to(cuda)
    q, s = ops.quantize_rows(x)
    s = s.to(getattr(torch, scale_dtype))
    reset_launches()
    out = ops.dequantize_rows(q, s, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert LAUNCHES["dequantize"] == 1 and out.dtype == torch.bfloat16
    assert torch.equal(out, dequantize_ref(q, s, torch.bfloat16))


_F32, _BF16 = "float32", "bfloat16"
_LENET = [((6,), _F32), ((5, 5, 1, 6), _F32), ((16,), _F32), ((5, 5, 6, 16), _F32),
          ((120,), _F32), ((784, 120), _F32), ((84,), _F32), ((120, 84), _F32),
          ((10,), _F32), ((84, 10), _F32)]
# name -> [(shape, dtype)] in tree order; a "misaligned" tree lays every
# leaf 4 bytes past a 16-byte aligned base (the scalar path for all of them)
QUANTIZE_TREES = {
    "lenet": _LENET,
    "lenet_misaligned": _LENET,
    "odd": [((), _F32), ((4, 0), _F32), ((0, 5), _F32), ((6,), _F32)],
    "ragged": [((5, 300), _F32), ((2, 3, 520), _F32), ((3, 257), _F32),
               ((1001, 256), _F32), ((1001, 77), _F32)],
    "bf16": [(shape, _BF16) for shape, _ in _LENET] + [((4, 520), _BF16)],
    "mixed": [((120,), _BF16), ((4, 520), _BF16), ((7, 10), _F32),
              ((32, 120), _F32), ((64, 1024), _F32)],
    "many": [(((i % 5) + 1, 4 + 3 * i), _F32) for i in range(70)],
    "misaligned": [((784, 120), _F32), ((120, 84), _F32), ((64, 256), _BF16)],
}


def _tree_leaves(name, device):
    g = torch.Generator().manual_seed(len(name))
    leaves = []
    for shape, dtype in QUANTIZE_TREES[name]:
        x = torch.randn(shape, generator=g) * 3.0
        if x.numel() > 8:
            x.view(-1)[:8] = torch.tensor([0.0, 1e-30, -1e-30, 127.0, 0.5, 1.5,
                                           2.5, -2.5])        # ties, tiny, zero
        x = x.to(device, getattr(torch, dtype))
        if name.endswith("misaligned"):
            off = 4 // x.element_size()
            x = torch.empty(off + x.numel(), dtype=x.dtype,
                            device=device)[off:].view(x.shape).copy_(x)
        leaves.append(x)
    return leaves


@pytest.mark.parametrize("name", sorted(QUANTIZE_TREES))
def test_tree_kernels_bitwise_vs_plain(cuda, name):
    """quantize_tree / dequantize_tree / roundtrip_tree against the plain
    version that walks the same segment table, on the card; one launch a
    direction for every 64 leaves."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.quantize import ops, ref, table
    leaves = _tree_leaves(name, cuda)
    specs = [(tuple(x.shape), x.dtype) for x in leaves]
    groups = len(table.plan_for(leaves, 256).groups)
    reset_launches()
    pairs = ops.quantize_tree(leaves)
    want = ref.quantize_tree_ref(leaves, 256)
    for (q, s), (qr, sr) in zip(pairs, want):
        assert q.shape == qr.shape and s.dtype == sr.dtype == torch.bfloat16
        assert torch.equal(q, qr) and torch.equal(s, sr)
    for got in (ops.dequantize_tree(pairs, specs), ops.roundtrip_tree(leaves)):
        for o, w, x in zip(got, ref.dequantize_tree_ref(pairs, specs), leaves):
            assert o.shape == x.shape and o.dtype == x.dtype
            assert torch.equal(o, w)
    torch.cuda.synchronize()
    assert LAUNCHES["quantize"] == 2 * groups and LAUNCHES["dequantize"] == 2 * groups


def test_lenet_broadcast_launches_one_kernel_each_way(cuda):
    """The main path's wire: one roundtrip_tree of LeNet's params adds one
    launch to each counter."""
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.core import compression
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lenet
    params = lenet.init(torch.Generator(device=cuda).manual_seed(0), CONFIG, cuda)
    compression.roundtrip_tree(params)          # plan cached, library loaded
    torch.cuda.synchronize()
    reset_launches()
    back = compression.roundtrip_tree(params)
    torch.cuda.synchronize()
    assert dict(LAUNCHES) == {"quantize": 1, "dequantize": 1}
    want = compression.roundtrip_tree(
        {k: {kk: v.cpu() for kk, v in d.items()} for k, d in params.items()})
    for k in params:
        for kk in params[k]:
            assert torch.equal(back[k][kk].cpu(), want[k][kk])


def test_two_seeded_heap_runs_are_bitwise_equal_on_the_card(cuda):
    """The main path's recipe on the heap simulator (training on, the int8
    wire and the wfedavg kernel) cut to its first 36 ticks, run twice: every
    node's params, reputations and test accuracy history bitwise equal.
    Node addresses come from fresh RSA keys, so reputations are compared by
    node name."""
    from repro_torch import tree
    from repro_torch.chain import scenarios
    from repro_torch.core.reputation import IMPL2

    def run():
        sc, spec, topo, cfg = scenarios.lenet_paper_setup(n=10, ticks=36,
                                                          compress="int8")
        sim = scenarios.make_heap_simulator(sc, topo, spec, IMPL2, cfg,
                                            use_kernel=True, device="cuda")
        sim.run()
        torch.cuda.synchronize()
        return sim, {nd.info.address: nd.name for nd in sim.nodes.values()}

    (a, names_a), (b, names_b) = run(), run()
    assert a.stats == b.stats and a.stats["fedavg_rounds"] > 0
    for na, nb in zip(a.nodes.values(), b.nodes.values()):
        for x, y in zip(tree.leaves(na.params), tree.leaves(nb.params)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32)), na.name
        assert na.accuracy_history == nb.accuracy_history
        assert ({names_a[k]: v for k, v in na.reputation.items()}
                == {names_b[k]: v for k, v in nb.reputation.items()})


@pytest.mark.parametrize("n,d,offset", [(10, 94080, 0), (10, 10080, 0),
                                        (10, 10081, 0), (3, 4100, 1), (7, 4100, 1),
                                        (1, 4096, 0)])
def test_wfedavg_kernel_vs_plain(cuda, n, d, offset):
    from repro_torch.kernels.wfedavg import ops
    from repro_torch.kernels.wfedavg.ref import wfedavg_ref
    g = torch.Generator().manual_seed(d)
    models = (torch.randn((n, d + offset), generator=g) * 0.05).to(cuda)[:, offset:]
    prev = (torch.randn((d + offset,), generator=g) * 0.05).to(cuda)[offset:]
    wn = torch.softmax(torch.randn((n,), generator=g), 0).to(cuda)
    out = ops.wfedavg_flat(models, wn, prev)
    torch.testing.assert_close(out, wfedavg_ref(models, wn, prev),
                               rtol=1e-6, atol=1e-6)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.quantize import ops as q_ops
    from repro_torch.kernels.wfedavg import ops as wf_ops
    with pytest.raises(ValueError):
        q_ops.quantize_rows(torch.zeros((4, 300), device=cuda))
    with pytest.raises(TypeError):
        q_ops.quantize_rows(torch.zeros((4, 8), device=cuda, dtype=torch.float16))
    with pytest.raises(ValueError):
        q_ops.roundtrip_tree([torch.zeros(4, device=cuda), torch.zeros(4)])
    with pytest.raises(TypeError):
        q_ops.dequantize_rows(torch.zeros((4, 8), device=cuda, dtype=torch.int8),
                              torch.ones((4, 1), device=cuda), dtype=torch.float16)
    with pytest.raises(TypeError):
        wf_ops.wfedavg_flat(torch.zeros((2, 8), device=cuda, dtype=torch.float64),
                            torch.ones(2, device=cuda), torch.zeros(8, device=cuda))


def _simt_view(x):
    """The values of ``x`` in a view whose base lies 8 bytes past a 16-byte
    aligned one: the routing rule sends bf16 tensors laid out so to the
    simt kernel, at any head dim."""
    off = 8 // x.element_size()
    view = torch.empty(off + x.numel(), dtype=x.dtype, device=x.device)[off:]
    return view.view(x.shape).copy_(x)


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window", [
    (1, 512, 32, 8, 128, True, 0),       # llama3's heads
    (1, 512, 16, 8, 256, True, 128),     # gemma3's local heads, a window
    (2, 200, 4, 2, 64, False, 0),        # bidirectional, ragged
    (1, 77, 4, 1, 80, True, 0),          # KH = 1, hubert's head dim (bf16: sm90)
    (1, 130, 4, 4, 16, True, 0),         # KH = H, the smoke head dim
    (1, 4096, 32, 8, 128, True, 0),      # the serving path's heads at S 4096
    (1, 4096, 16, 8, 256, True, 1024),   # gemma3's local layer at S 4096
    (1, 2048, 16, 4, 64, False, 0),      # bidirectional, Dh 64
    (2, 1000, 32, 8, 128, True, 0),      # ragged S
    (1, 4095, 32, 8, 128, True, 0),      # ragged S, the consistency check's length
    (1, 1024, 8, 1, 128, True, 0),       # KH = 1
    (1, 1024, 8, 8, 128, True, 0),       # KH = H
    (2, 1000, 16, 16, 80, False, 0),     # hubert's heads, bidirectional, ragged
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_vs_plain(cuda, B, S, H, KH, Dh, causal, window,
                                         dtype):
    """Each kernel the routing rule reaches, against the plain version: in
    fp32 the simt kernel (1e-5); in bf16 at an sm90 head dim the sm90 kernel
    on the tensors as made and the simt kernel on ``_simt_view`` copies,
    else the simt kernel (one bf16 ulp). The route is read from the launch
    counters."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(S * H + Dh)
    td = getattr(torch, dtype)
    q = torch.randn((B, S, H, Dh), generator=g).to(cuda, td)
    k = torch.randn((B, S, KH, Dh), generator=g).to(cuda, td)
    v = torch.randn((B, S, KH, Dh), generator=g).to(cuda, td)
    want = attention_ref(q, k, v, causal=causal, window=window).float()
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    sm90 = dtype == "bfloat16" and Dh in ops.SM90_HEAD_DIMS
    runs = [(sm90, (q, k, v))]
    if sm90:
        runs.append((False, tuple(_simt_view(x) for x in (q, k, v))))
    for route_sm90, qkv in runs:
        reset_launches()
        out = ops.flash_attention(*qkv, causal=causal, window=window)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention"] == 1 and out.dtype == td
        assert LAUNCHES["flash_attention_sm90"] == route_sm90
        torch.testing.assert_close(out.float(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("B,S,H,KH,causal,window", [
    (2, 1000, 16, 16, False, 0),         # hubert's heads, bidirectional, ragged
    (1, 77, 4, 1, True, 0),              # KH = 1
    (1, 300, 8, 2, True, 100),           # a window
])
def test_flash_attention_simt_kernel_at_dh80_in_bf16(cuda, B, S, H, KH, causal,
                                                     window):
    """The simt kernel stays held at Dh 80 in bf16, where the routing rule
    now sends aligned tensors to the sm90 kernel: ``_simt_view`` copies go
    to the simt kernel."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(S * H + 80 + window)
    q, k, v = (_simt_view(torch.randn((B, S, heads, 80), generator=g).to(cuda, torch.bfloat16))
               for heads in (H, KH, KH))
    assert ops._variant(q, k, v) == "simt"
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1 and LAUNCHES["flash_attention_sm90"] == 0
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), rtol=1.6e-2, atol=1.6e-2)


def test_flash_attention_kernel_takes_strided_inputs(cuda):
    """q, k, v as views of one fused projection output (not contiguous)."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(5)
    qkv = torch.randn((2, 100, 8 + 2 + 2, 32), generator=g).to(cuda)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    torch.testing.assert_close(ops.flash_attention(q, k, v),
                               attention_ref(q, k, v), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., ::2], k[..., ::2], v[..., ::2])   # Dh stride 2
    with pytest.raises(ValueError):
        ops.flash_attention(q[..., :12], k[..., :12], v[..., :12])   # Dh 12
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), k.half(), v.half())


@pytest.mark.parametrize("B,Sq,H,KH,Dh,causal,window", [
    (1, 512, 32, 8, 128, True, 0),       # llama3's heads
    (2, 200, 4, 2, 64, False, 0),        # bidirectional, ragged S
    (1, 200, 8, 2, 128, True, 0),        # ragged S inside one key tile
    (1, 4095, 8, 2, 128, True, 0),       # ragged S, the consistency check's length
    (1, 512, 16, 8, 256, True, 128),     # gemma3's local heads, a window
    (1, 1000, 4, 2, 256, True, 0),       # Dh 256, ragged
    (1, 300, 8, 1, 128, True, 0),        # KH = 1
    (1, 300, 8, 8, 64, True, 100),       # KH = H, a window
    (2, 1000, 16, 16, 80, False, 0),     # hubert's heads, bidirectional, ragged S
    (1, 333, 8, 1, 80, True, 0),         # Dh 80, causal, KH = 1
    (1, 700, 8, 2, 80, True, 200),       # Dh 80, a window
])
def test_flash_attention_sm90_kernel_vs_plain(cuda, B, Sq, H, KH, Dh, causal,
                                              window):
    """The Hopper kernel (bf16 wgmma, TMA) against the plain version at one
    bf16 ulp (it rounds p to bf16 before P.V, as the JAX model does)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(Sq * H + Dh + window)
    q = torch.randn((B, Sq, H, Dh), generator=g).to(cuda, torch.bfloat16)
    k = torch.randn((B, Sq, KH, Dh), generator=g).to(cuda, torch.bfloat16)
    v = torch.randn((B, Sq, KH, Dh), generator=g).to(cuda, torch.bfloat16)
    assert ops._variant(q, k, v) == "sm90"
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_sm90"] == 1 and LAUNCHES["flash_attention"] == 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), want.float(), rtol=1.6e-2, atol=1.6e-2)


@pytest.mark.parametrize("Dh", [64, 80, 128, 256])
def test_flash_attention_sm90_takes_fused_projection_views(cuda, Dh):
    """q, k, v as views of one fused projection output: the strides reach
    the tensor maps as they are (no copy), and a view TMA cannot take goes
    to the simt kernel."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(Dh)
    qkv = torch.randn((2, 333, 8 + 2 + 2, Dh), generator=g).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    reset_launches()
    out = ops.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_sm90"] == 1
    torch.testing.assert_close(out.float(), attention_ref(q, k, v).float(),
                               rtol=1.6e-2, atol=1.6e-2)
    flat = qkv.reshape(-1)[2:2 + q.numel()].view(q.shape)    # 4-byte base offset
    reset_launches()
    ops.flash_attention(flat, flat[:, :, :2], flat[:, :, 2:4])
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1 and LAUNCHES["flash_attention_sm90"] == 0


def test_lax_compact_wire_is_one_kernel_pair_a_training_tick(cuda):
    """The vectorized engine's int8 wire: one quantize and one dequantize
    launch for each tick on which some node trains, whatever the number of
    trainers (the stacked tree goes through in one round trip)."""
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches
    n, interval = 12, 4
    countdown = [1 + (3 * i) % 5 for i in range(n)]
    spec = attacks.FederationSpec.build(n, malicious=(0,), attack="signflip",
                                        initial_countdown=countdown)
    cfg = simlax.SimLaxConfig(ticks=30, train_interval=(interval, interval),
                              latency=1, ttl=2, record_every=10,
                              compress="int8")
    sim = simlax.LaxSimulator(scenarios.toy_scenario(n, malicious=(0,)),
                              topology.kregular(n, 2), spec, IMPL2, cfg,
                              device="cuda")
    reset_launches()
    res = sim.run()
    torch.cuda.synchronize()
    nxt, training_ticks = list(countdown), 0
    for _ in range(cfg.ticks):
        nxt = [c - 1 for c in nxt]
        trained = [i for i, c in enumerate(nxt) if c <= 0]
        for i in trained:
            nxt[i] = interval
        training_ticks += bool(trained)
    assert res.stats["broadcasts"] > training_ticks > 0
    assert LAUNCHES["quantize"] == LAUNCHES["dequantize"] == training_ticks


def _lax_same(a, b, floats):
    """Two vectorized-engine results: the event counts, per-node broadcasts,
    the integer final state and the reputations exactly; the float state,
    params and test accuracies by ``floats``: "bitwise" (the broadcasts
    too), "rtol" (1e-6) or "int8" (params off by more than 1e-5 on at most
    1e-4 of their entries and by at most one quantization step, the int8
    wire's boundary flips; test accuracies within 2 of 64)."""
    from repro_torch import tree
    for k in ("broadcasts", "deliveries", "fedavg_rounds", "max_tick_deliveries"):
        assert a.stats[k] == b.stats[k], k
    np.testing.assert_array_equal(a.stats["broadcasts_per_node"],
                                  b.stats["broadcasts_per_node"])
    for k in ("arrive", "buf_cnt", "next_train", "min_sender"):
        np.testing.assert_array_equal(a.final_state[k], b.final_state[k])
    np.testing.assert_array_equal(a.reputation, b.reputation)
    pairs = [(a.final_state[k], b.final_state[k]) for k in ("w_sum", "min_acc")]
    pairs += list(zip(tree.leaves(a.params), tree.leaves(b.params)))
    if floats == "bitwise":
        pairs += list(zip(tree.leaves(a.sent), tree.leaves(b.sent)))
        pairs.append((a.acc_history, b.acc_history))
    for x, y in pairs:
        if floats == "bitwise":
            np.testing.assert_array_equal(x, y)
        elif floats == "rtol":
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=0)
        else:
            diff = np.where(x == y, 0.0, np.abs(x.astype(np.float64) - y))
            off = diff > 1e-5
            assert not off.any() or (off.mean() <= 1e-4
                                     and diff.max() <= np.abs(y).max() / 127.0)
    if floats == "rtol":
        np.testing.assert_allclose(a.acc_history, b.acc_history, rtol=1e-6, atol=0)
    if floats == "int8":
        assert np.abs(a.acc_history - b.acc_history).max(initial=0.0) <= 2 / 64


def _lax_toy(engine, device, *, fixed=False, attack="gaussian"):
    """tests/test_torch_simlax.py's kregular case (n 14, degree 3, ttl 2, a
    dead node, a straggler, 90 ticks, int8 wire); random train intervals
    unless ``fixed``."""
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    n = 14
    spec = attacks.FederationSpec.build(
        n, malicious=(2, 9), attack=attack, dead=(5,), stragglers={1: 4},
        initial_countdown=[1 + (3 * i) % 4 for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=90, train_interval=(4, 4 if fixed else 8),
                              latency=1, ttl=2, record_every=18, seed=1,
                              delivery=engine, compress="int8")
    sc = scenarios.toy_scenario(n, dim=8, malicious=(2, 9))
    return simlax.LaxSimulator(sc, topology.make("kregular", n, degree=3), spec,
                               IMPL2, cfg, device=device).run()


def _lax_lenet(engine, device, *, train_steps=0, attack="signflip", fixed=True,
               params0=None, seed=0):
    """A small LeNet federation at full width: n 6, node 0 poisoning,
    kregular(6, 2), 24 ticks, small data, int8 wire."""
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    n = 6
    sc = scenarios.lenet_scenario(n, malicious=(0,), train_steps=train_steps, pool=32,
                                  eval_size=16, test_size=64, batch=8)
    spec = attacks.FederationSpec.build(
        n, malicious=(0,), attack=attack, initial_countdown=[1 + i % 3 for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=24, train_interval=(3, 3 if fixed else 5),
                              latency=1, ttl=2, record_every=4, seed=seed,
                              delivery=engine, compress="int8")
    return simlax.LaxSimulator(sc, topology.kregular(n, 2), spec, IMPL2, cfg,
                               device=device).run(params0)


def _lax_batch(device):
    """Eight heterogeneous toy federations (n 16, 48 ticks) batched on the
    compact engine with fixed intervals and deterministic attacks: mixed
    attackers, a dead node, stragglers, an explicit countdown, honest
    baselines."""
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    n, build = 16, attacks.FederationSpec.build
    specs = [build(n, malicious=(0,), attack="signflip"),
             build(n, malicious={2: "signflip", 5: "signflip"}, stragglers={7: 2}),
             build(n, malicious=(1, 3), attack="scaled", dead=(n - 1,)),
             build(n),
             build(n, malicious=(4,), attack="freerider"),
             build(n, malicious=(0, 2), attack=attacks.make("intermittent", inner="signflip"),
                   initial_countdown=[1 + (3 * i) % 7 for i in range(n)]),
             build(n, dead=(2, 5)),
             build(n, malicious=(6,), attack="signflip", stragglers={1: 3})]
    cfg = simlax.SimLaxConfig(ticks=48, train_interval=(8, 8), latency=2, ttl=2,
                              record_every=10, delivery="compact")
    return simlax.LaxSimulator(
        scenarios.toy_scenario(n, dim=8), topology.kregular(n, 2),
        attacks.BatchedFederationSpec.build(specs, [3 * b + 1 for b in range(8)]),
        IMPL2, cfg, device=device).run()


@pytest.mark.parametrize("case", ["toy", "lenet", "batch"])
def test_lax_engines_and_the_cpu_agree_with_compact_on_the_card(cuda, case):
    """The vectorized engine on the card: the sparse and dense delivery
    engines agree with compact (rtol 1e-6); compact on the card agrees with
    compact on the CPU (the toy and a batch of eight toy federations within
    rtol 1e-6, with fixed intervals and deterministic attacks; LeNet from
    the same params under the int8 boundary rule); two seeded card runs
    are bitwise equal."""
    from repro_torch import convert
    from repro_torch.chain import scenarios
    if case == "batch":
        for card, cpu in zip(_lax_batch("cuda"), _lax_batch("cpu")):
            _lax_same(card, cpu, "rtol")
        return
    if case == "toy":
        runs = {e: _lax_toy(e, "cuda") for e in ("compact", "sparse", "dense")}
        card, cpu = (_lax_toy("compact", d, fixed=True, attack="signflip")
                     for d in ("cuda", "cpu"))
        again = [_lax_toy("compact", "cuda") for _ in range(2)]
        close = "rtol"
    else:
        runs = {e: _lax_lenet(e, "cuda", train_steps=1, attack="gaussian", fixed=False)
                for e in ("compact", "sparse", "dense")}
        params0 = convert.params_to_numpy(scenarios.lenet_scenario(
            6, malicious=(0,), train_steps=0, pool=32, eval_size=16, test_size=64,
            batch=8).init_params_stacked("cuda"))
        card, cpu = (_lax_lenet("compact", d, params0=params0) for d in ("cuda", "cpu"))
        again = [_lax_lenet("compact", "cuda", train_steps=2, attack="gaussian",
                            fixed=False, seed=3) for _ in range(2)]
        close = "int8"
    assert runs["compact"].stats["deliveries"] > 0
    for engine in ("sparse", "dense"):
        _lax_same(runs["compact"], runs[engine], "rtol")
    _lax_same(card, cpu, close)
    _lax_same(*again, "bitwise")


def _hetero_toy_specs(n):
    from repro_torch.chain import attacks
    build = attacks.FederationSpec.build
    return [build(n, malicious=(0,), attack="gaussian"),
            build(n, malicious={2: "signflip", 5: "gaussian"}, stragglers={7: 2}),
            build(n, malicious=(1, 3), attack="scaled", dead=(n - 1,)),
            build(n),
            build(n, malicious=(0, 2), attack="intermittent",
                  initial_countdown=[1 + (3 * i) % 7 for i in range(n)])]


@pytest.mark.parametrize("engine", ["compact", "sparse", "dense"])
def test_batched_members_are_their_single_runs_on_the_card(cuda, engine):
    """A batch of heterogeneous toy federations on the card: every member
    bitwise its single card run; the int8 wire is one quantize and one
    dequantize launch a training tick for the whole batch."""
    import dataclasses

    import numpy as np

    from repro_torch import tree
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches
    n = 16
    specs, seeds = _hetero_toy_specs(n), [1, 4, 7, 10, 13]
    sc, topo = scenarios.toy_scenario(n, dim=8), topology.kregular(n, 2)
    cfg = simlax.SimLaxConfig(ticks=40, train_interval=(8, 12), latency=2, ttl=2,
                              record_every=10, delivery=engine, compress="int8")
    reset_launches()
    batch = simlax.LaxSimulator(sc, topo, attacks.BatchedFederationSpec.build(
        specs, seeds), IMPL2, cfg, device="cuda").run()
    torch.cuda.synchronize()
    wire = (LAUNCHES["quantize"], LAUNCHES["dequantize"])
    singles = []
    for b, (spec, seed) in enumerate(zip(specs, seeds)):
        reset_launches()
        single = simlax.LaxSimulator(sc, topo, spec, IMPL2,
                                     dataclasses.replace(cfg, seed=seed),
                                     device="cuda").run()
        torch.cuda.synchronize()
        singles.append(LAUNCHES["quantize"])
        for x, y in zip(tree.leaves(batch[b].params) + tree.leaves(batch[b].sent),
                        tree.leaves(single.params) + tree.leaves(single.sent)):
            assert np.array_equal(x, y), (engine, b)
        assert np.array_equal(batch[b].reputation, single.reputation)
        assert np.array_equal(batch[b].acc_history, single.acc_history)
        for k in ("arrive", "w_sum", "buf_cnt", "min_sender", "next_train"):
            assert np.array_equal(batch[b].final_state[k], single.final_state[k]), k
        assert batch[b].stats["deliveries"] == single.stats["deliveries"]
    # one round trip a tick on which any member trains: at least the
    # busiest member's training ticks, fewer than all members' together
    assert wire[0] == wire[1]
    assert max(singles) <= wire[0] < sum(singles)


def test_lenet_sgd_graph_route_is_the_eager_route(cuda):
    """Small stacked SGD calls replay a captured CUDA graph on the card:
    the same bits as the eager route, at 1, 2 and GRAPH_MODELS models."""
    from repro_torch import device as device_lib
    from repro_torch import tree
    from repro_torch.chain import scenarios
    sc = scenarios.lenet_scenario(6, pool=32, eval_size=8, test_size=16,
                                  train_steps=2, batch=8)
    params, data = sc.init_params_stacked("cuda"), sc.train_data("cuda")
    g = torch.Generator(device="cuda").manual_seed(3)
    with device_lib.deterministic():
        for m in (1, 2, 6):
            rows = torch.arange(m, device="cuda")
            idx = torch.randint(0, 32, (m, 2, 8), generator=g, device="cuda")
            models = tree.map(lambda x: x[rows], params)
            graphed = sc.sgd_stacked(models, data, rows, idx)
            again = sc.sgd_stacked(models, data, rows, idx)     # a replay
            eager = sc._sgd_steps(models, lambda s: {
                "images": data["images"][rows[:, None], idx[:, s]],
                "labels": data["labels"][rows[:, None], idx[:, s]]}, 2)
            for a, b, c in zip(tree.leaves(graphed), tree.leaves(again),
                               tree.leaves(eager)):
                assert torch.equal(a.view(torch.int32), c.view(torch.int32))
                assert torch.equal(b.view(torch.int32), c.view(torch.int32))
    assert len(sc._graphs) == 3


@pytest.mark.parametrize("shape", [(0,), (5,), (257,), (784, 120)])
def test_quantize_tensor_on_the_card_is_the_plain_version(cuda, shape):
    """The flat-block forms through the kernel pair (a one-segment table):
    q, scales and the dequantized tensor bitwise the CPU plain version's;
    one launch each way."""
    from repro_torch.core import compression
    from repro_torch.kernels import LAUNCHES, reset_launches
    x = torch.randn(shape, generator=torch.Generator().manual_seed(5)) * 3.0
    q_c, s_c = compression.quantize_tensor(x)
    reset_launches()
    q_g, s_g = compression.quantize_tensor(x.cuda())
    out = compression.dequantize_tensor(q_g, s_g, shape, torch.float32)
    torch.cuda.synchronize()
    assert torch.equal(q_g.cpu(), q_c) and torch.equal(s_g.cpu(), s_c)
    assert torch.equal(out.cpu(), compression.dequantize_tensor(
        q_c, s_c, shape, torch.float32))
    rows = q_c.shape[0]
    assert LAUNCHES["quantize"] == LAUNCHES["dequantize"] == (1 if rows else 0)


def test_run_sweep_defaults_to_the_card(cuda):
    from repro_torch.chain import simlax, sweeps
    cells = sweeps.expand_grid(sizes=[8], attacks=[None, "gaussian"], seeds=[0, 1])
    out = sweeps.run_sweep(cells, cfg=simlax.SimLaxConfig(
        ticks=12, train_interval=(4, 4), ttl=1, record_every=4), target_acc=0.3)
    assert [o.stats["batch_size"] for o in out] == [4] * 4
    assert sweeps.frontier_tables(out, target_acc=0.3)["time_to_accuracy"]


def test_sharded_single_shard_lenet_is_compact_on_the_card(cuda):
    """delivery="sharded" in process (one shard): the compact engine's
    calls at the compact engine's shapes, so bit for bit its result."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.chain import attacks, scenarios, simlax
    from repro_torch.core import topology
    from repro_torch.core.reputation import IMPL2
    n = 8
    sc = scenarios.lenet_scenario(n, malicious=(0,), pool=32, eval_size=8,
                                  test_size=32, train_steps=1, batch=8)
    spec = attacks.FederationSpec.build(
        n, malicious=(0,), initial_countdown=[3 + (7 * i) % 6 for i in range(n)])
    cfg = simlax.SimLaxConfig(ticks=24, train_interval=(6, 6), latency=1, ttl=2,
                              record_every=8, compress="int8")
    a, b = (simlax.LaxSimulator(sc, topology.kregular(n, 2), spec, IMPL2, c,
                                device="cuda").run()
            for c in (cfg, dataclasses.replace(cfg, delivery="sharded")))
    assert a.stats["deliveries"] > 0 and b.stats["shards"] == 1
    assert all(a.stats[k] == b.stats[k] for k in ("broadcasts", "deliveries",
                                                  "fedavg_rounds"))
    for k in a.final_state:
        np.testing.assert_array_equal(a.final_state[k], b.final_state[k])
    np.testing.assert_array_equal(a.reputation, b.reputation)
    np.testing.assert_array_equal(a.acc_history, b.acc_history)
    for x, y in zip(tree.leaves(a.params) + tree.leaves(a.sent),
                    tree.leaves(b.params) + tree.leaves(b.sent)):
        np.testing.assert_array_equal(x, y)


def _int8_round_rank(rank, device):
    """One of two ranks on one card: LeNet-5 params from seed 40 + rank,
    one int8 gossip round; returns (new params, wire counters, launches)."""
    from repro_torch import convert
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.core import gossip, topology
    from repro_torch.core.reputation import IMPL2
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import lenet
    params = lenet.init(torch.Generator(device=device).manual_seed(40 + rank),
                        CONFIG, device)
    round_ = gossip.make_gossip_round(
        lambda p, vb: torch.tensor(0.5, device=device), fed_size=2, ttl=1,
        rep_impl=IMPL2, compress="int8", topology=topology.ring(2))
    reset_launches()
    gossip.reset_wire()
    new, rep, met = round_(params, torch.ones(2, device=device), None)
    torch.cuda.synchronize()
    out = (convert.params_to_numpy(new), dict(gossip.WIRE), dict(LAUNCHES),
           rep.cpu().numpy(), float(met["models_received"]))
    every = [None, None]
    torch.distributed.all_gather_object(every, out)
    return every


def test_int8_round_on_two_ranks_of_one_card_matches_its_oracle(cuda):
    """Two ranks on cuda:0 under gloo (the exchange staged through host
    memory): each quantizes once, sends the int8 payload, dequantizes what
    it receives, and averages it with its own model (one sender: Eq. 3 is
    the mean of the two)."""
    from repro_torch import tree
    from repro_torch.configs.lenet_dfl import CONFIG
    from repro_torch.core import compression
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.models import lenet
    got = mesh_lib.spawn(_int8_round_rank, 2, device="cuda:0", backend="gloo",
                         timeout=240)
    params = [lenet.init(torch.Generator(device="cuda").manual_seed(40 + r),
                         CONFIG, "cuda") for r in range(2)]
    for r in range(2):
        new, wire, launches, rep, received = got[r]
        other = compression.roundtrip_tree(params[1 - r])
        for x, own, o in zip(tree.leaves(new), tree.leaves(params[r]),
                             tree.leaves(other)):
            want = (0.5 * (o.double() + own.double())).cpu().numpy()
            np.testing.assert_allclose(x, want, rtol=1e-6, atol=1e-7)
        assert wire["bytes"] == compression.payload_bytes(params[r], "int8")
        assert wire["messages"] == 1 and received == 1.0
        assert launches["quantize"] == 1 and launches["dequantize"] == 1
        np.testing.assert_array_equal(rep, np.ones(2, np.float32))


# ------------------------------------------------------------ LM training
# "simt" in bf16 at Dh 128: the simt kernel on ``_simt_view`` copies
@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window,dtype,route", [
    (2, 4096, 32, 8, 128, True, 0, "bfloat16", "sm90"),   # the training shape
    (1, 4096, 32, 8, 128, True, 512, "bfloat16", "sm90"),
    (2, 1000, 4, 2, 16, True, 0, "float32", "simt"),
    (1, 1024, 32, 8, 128, True, 0, "bfloat16", "simt"),
    (1, 1024, 8, 2, 128, True, 0, "bfloat16", "sm90"),
    (1, 1000, 8, 2, 64, True, 128, "bfloat16", "sm90"),
    (1, 512, 4, 2, 256, False, 0, "bfloat16", "sm90"),
    (2, 1000, 16, 16, 80, False, 0, "bfloat16", "sm90"),
    (2, 100, 4, 2, 16, True, 0, "float32", "simt"),
    (2, 100, 4, 2, 16, True, 32, "bfloat16", "simt"),
    (1, 20, 2, 1, 8, True, 4, "float32", "simt"),
    (1, 1024, 32, 2, 128, True, 0, "bfloat16", "sm90"),   # chatglm3's heads
])
def test_flash_lse_and_backward_vs_plain(cuda, B, S, H, KH, Dh, causal, window,
                                         dtype, route):
    """Both kernels write the plain version's output (within 1e-5 in fp32,
    one bf16 ulp in bf16, absolute) and log-sum-exp (abs 2e-5 on values of
    ~5-10, ten times the largest read on an H100; -1e38 for a row without
    kept keys), and the model's backward on the kernel's lse matches
    autograd through the plain version within the bf16 rounding of p, dout
    and ds (relative L2 1e-2). The backward takes the sm90 kernel after an
    sm90 forward at Dh 64 or 128, the plain recompute otherwise, once each,
    read from the launch counters."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import flash
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S + Dh)
    q = torch.randn((B, S, H, Dh), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, S, KH, Dh), generator=g, device="cuda").to(dt)
            for _ in range(2))
    if route == "simt" and dt == torch.bfloat16 and Dh in ops.SM90_HEAD_DIMS:
        q, k, v = (_simt_view(x) for x in (q, k, v))
    reset_launches()
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert LAUNCHES["flash_attention_sm90"] == (route == "sm90")
    want, want_lse = attention_ref(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)
    assert float((out.float() - want.float()).abs().max()) <= tol
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)
    del want, want_lse
    dout = torch.randn(out.shape, generator=g, device="cuda").to(dt)
    grads = []
    for fn in ("kernel", "plain"):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        if fn == "kernel":
            flash.flash_attention_padded(xs[0].reshape(B, S, KH, H // KH, Dh), xs[1],
                                         xs[2], causal, window).reshape(
                                             out.shape).backward(dout)
        else:
            attention_ref(*xs, causal=causal, window=window).backward(dout)
        grads.append([x.grad.float() for x in xs])
    for a, b in zip(*grads):
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-2, rel
    # the model's forward runs on clones (aligned): sm90 in bf16 at its head dims
    bwd = "sm90" if dtype == "bfloat16" and Dh in (64, 128) else "plain"
    assert LAUNCHES["flash_attention_bwd_sm90"] == (bwd == "sm90")
    assert LAUNCHES["flash_backward_plain"] == (bwd == "plain")


def test_lse_of_rows_without_kept_keys_on_both_kernels(cuda):
    """Query rows past Skv + window keep no key: both kernels write -1e38,
    the plain version's LSE_EMPTY."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import LSE_EMPTY, attention_ref
    g = torch.Generator(device="cuda").manual_seed(9)
    for Dh, dtype in ((16, torch.float32), (128, torch.bfloat16)):
        q = torch.randn((1, 300, 2, Dh), generator=g, device="cuda").to(dtype)
        k, v = (torch.randn((1, 100, 2, Dh), generator=g, device="cuda").to(dtype)
                for _ in range(2))
        _, lse = ops.flash_attention(q, k, v, causal=True, window=50, return_lse=True)
        _, want = attention_ref(q, k, v, causal=True, window=50, return_lse=True)
        empty = torch.arange(300, device="cuda") >= 100 + 50 - 1
        assert bool((lse[..., empty] == LSE_EMPTY).all())
        torch.testing.assert_close(lse[..., ~empty], want[..., ~empty], rtol=0,
                                   atol=2e-5)


# (B, Sq, Skv, H, KH, Dh, causal, window, layout): G = H / KH 1, 4 and 16
# (chatglm3's 32 / 2), Dh 64 and 128, ragged S 1000, rows past Skv + window
# without a kept key, causal key tiles past Sq without a kept query, and q,
# k, v as views of one fused (B, S, H + 2 KH, Dh) projection ("fused") or
# with a padded head stride ("padded")
BWD_CASES = [
    (1, 1024, 1024, 8, 8, 128, True, 0, "contiguous"),
    (2, 1000, 1000, 8, 2, 64, True, 0, "contiguous"),
    (1, 1024, 1024, 32, 2, 128, True, 0, "fused"),
    (1, 1000, 1000, 16, 1, 128, False, 0, "contiguous"),
    (2, 1000, 1000, 4, 1, 64, False, 0, "fused"),
    (1, 1024, 1024, 8, 2, 128, True, 300, "contiguous"),
    (1, 1000, 1000, 8, 2, 64, False, 200, "padded"),
    (1, 300, 100, 4, 1, 64, True, 50, "contiguous"),
    (1, 300, 100, 16, 1, 128, True, 50, "padded"),
    (1, 100, 300, 8, 2, 64, True, 0, "contiguous"),
]


def _bwd_inputs(g, B, Sq, Skv, H, KH, Dh, layout):
    if layout == "fused":                  # Sq == Skv: one projection's views
        x = torch.randn((B, Sq, H + 2 * KH, Dh), generator=g, device="cuda").bfloat16()
        return x[:, :, :H], x[:, :, H:H + KH], x[:, :, H + KH:]
    pad = 8 if layout == "padded" else 0   # head stride Dh + 8
    return tuple(torch.randn((B, S, n, Dh + pad), generator=g, device="cuda")
                 .bfloat16()[..., :Dh] for S, n in ((Sq, H), (Skv, KH), (Skv, KH)))


@pytest.mark.parametrize("B,Sq,Skv,H,KH,Dh,causal,window,layout", BWD_CASES)
def test_flash_backward_sm90_kernel_vs_plain(cuda, B, Sq, Skv, H, KH, Dh, causal,
                                             window, layout):
    """The sm90 backward's dq, dk, dv against the plain ``flash_backward`` on
    the same bf16 inputs and lse: relative L2 1e-2 a gradient (chip_smoke's
    bound; both round p, dout and ds to bf16 with fp32 sums, in another
    order), every dk and dv element within 1e-2 of the gradient's largest
    magnitude; one launch, no plain route, outputs in the inputs' dtype."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import flash_backward
    g = torch.Generator(device="cuda").manual_seed(Sq + H + Dh + window)
    q, k, v = _bwd_inputs(g, B, Sq, Skv, H, KH, Dh, layout)
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    dout = torch.randn(out.shape, generator=g, device="cuda").bfloat16()
    assert ops._bwd_variant(q, k, v, out, lse, dout) == "sm90"
    reset_launches()
    got = ops.flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                       window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_bwd_sm90"] == 1
    assert LAUNCHES["flash_backward_plain"] == 0
    want = flash_backward(q, k, v, out, lse, dout, causal=causal, window=window)
    for name, a, b, x in zip(("dq", "dk", "dv"), got, want, (q, k, v)):
        assert a.dtype == x.dtype and a.shape == x.shape, name
        a, b = a.float(), b.float()
        rel = float((a - b).norm() / b.norm())
        assert rel < 1e-2, (name, rel)
        if name != "dq":
            gap = float((a - b).abs().max() / b.abs().max())
            assert gap < 1e-2, (name, gap)
    if Sq > Skv + window - 1 and causal and window:   # rows without a kept key
        empty = torch.arange(Sq, device="cuda") >= Skv + window - 1
        assert bool((got[0][:, empty] == 0).all())
    if causal and Skv > Sq:                           # keys without a kept query
        assert bool((got[1][:, Sq:] == 0).all()) and bool((got[2][:, Sq:] == 0).all())


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 1000), (False, 0)])
def test_flash_backward_sm90_gives_the_same_bits_each_call(cuda, causal, window):
    """The sm90 backward sums dq over the key tiles and dk, dv over a group's
    query heads in a fixed order, so calls on the same inputs agree bitwise:
    at chatglm3-6b's heads (H 32, KH 2: 16 heads a kv head) and S 4096, 32
    key tiles add into a dq row. A remat="dots" step is held bitwise to a
    "full" one on this."""
    from repro_torch.kernels.flash_attention import ops
    g = torch.Generator(device="cuda").manual_seed(28 + window)
    q, k, v = _bwd_inputs(g, 1, 4096, 4096, 32, 2, 128, "fused")
    out, lse = ops.flash_attention(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    dout = torch.randn(out.shape, generator=g, device="cuda").bfloat16()
    first = ops.flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                         window=window)
    for _ in range(3):
        again = ops.flash_attention_backward(q, k, v, out, lse, dout, causal=causal,
                                             window=window)
        for name, a, b in zip(("dq", "dk", "dv"), again, first):
            assert torch.equal(a, b), name


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_train_step_through_kernels_matches_plain_route(cuda, size):
    """One llama3-8b step (bf16 activations) through the kernels and with
    the attention forced through the plain version, at smoke size (Dh 64,
    B 2 x S 256) and at full width (depth 1, B 1 x S 1024): loss within
    2e-2, grads within 2e-2 relative L2 a leaf (twice the largest read on
    an H100 at full width, 9.2e-3 on the embedding table); the forward
    kernel launched twice a layer (forward, remat recompute), the backward
    kernel once, the plain route never."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import flash
    from repro_torch.train import step
    if size == "smoke":
        cfg = dataclasses.replace(smoke_config("llama3-8b"), head_dim=64,
                                  d_model=256)     # Dh 64: the sm90 kernel
        seed, B, S = 0, 2, 256
    else:
        cfg = dataclasses.replace(get_config("llama3-8b"), num_layers=1)
        seed, B, S = 3, 1, 1024
    state = step.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(seed),
                                  device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in TokenPipeline(cfg.vocab_size, B, S).batch_at(0).items()}
    reset_launches()
    loss_k, _, g_k = step.loss_and_grads(state["params"], cfg, batch)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_sm90"] == 2 * cfg.num_layers
    assert LAUNCHES["flash_attention_bwd_sm90"] == cfg.num_layers
    assert LAUNCHES["flash_backward_plain"] == 0
    reset_launches()
    with flash.plain_route():
        loss_p, _, g_p = step.loss_and_grads(state["params"], cfg, batch)
    assert not LAUNCHES
    assert abs(float(loss_k) - float(loss_p)) < 2e-2
    for a, b in zip(tree.leaves(g_k), tree.leaves(g_p)):
        assert float((a - b).norm() / b.norm()) < 2e-2


def test_train_launcher_defaults_to_the_card(cuda):
    from repro_torch import tree
    from repro_torch.launch import train
    state, history = train.main(["--arch", "llama3-8b", "--smoke", "--steps", "3",
                                 "--batch", "2", "--seq", "64"])
    assert all(x.device.type == "cuda" for x in tree.leaves(state))
    assert len(history) == 3 and all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.parametrize("size", ["smoke", "full"])
def test_remat_dots_step_is_the_full_step_on_the_card(cuda, size):
    """remat="dots" (dense products saved, the rest and the flash kernel
    recomputed) against "full" with the sm90 kernel, at smoke size (Dh 64,
    B 2 x S 256) and at llama3-8b's full width (depth 4, B 2 x S 4096): the
    same loss and grads within 1e-6 relative (the saved products are the
    ones the recompute would make again), the kernel launched twice a layer
    under both."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer
    from repro_torch.train import step
    if size == "smoke":
        base = dataclasses.replace(smoke_config("llama3-8b"), head_dim=64, d_model=256)
        B, S = 2, 256
    else:
        base = dataclasses.replace(get_config("llama3-8b"), num_layers=4)
        B, S = 2, 4096
    params = transformer.init(torch.Generator(device="cuda").manual_seed(0), base, "cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in TokenPipeline(base.vocab_size, B, S).batch_at(0).items()}
    runs = {}
    for remat in ("full", "dots"):
        reset_launches()
        runs[remat] = step.loss_and_grads(params, dataclasses.replace(base, remat=remat),
                                          batch)
        torch.cuda.synchronize()
        assert LAUNCHES["flash_attention_sm90"] == 2 * base.num_layers
    assert abs(float(runs["dots"][0]) - float(runs["full"][0])) <= 1e-6 * abs(
        float(runs["full"][0]))
    for a, b in zip(tree.leaves(runs["dots"][2]), tree.leaves(runs["full"][2])):
        assert float((a - b).norm()) <= 1e-6 * float(b.norm())


def test_dryrun_lax_runs_on_the_card_with_one_wire_pair_a_training_tick(cuda, tmp_path):
    """The dry-run command line's lax LeNet run (tests/test_torch_dryrun.py's
    flags) on its default device: the record says cuda, the counters are
    the CPU run's, the honest accuracy and the poisoners' reputation within
    0.05 of the CPU run's (the JAX bound of tests/test_torch_dryrun.py), and
    quantize / dequantize launch once a training tick (fixed interval 6,
    every tick has a trainer: 12)."""
    import json

    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.launch import dryrun
    argv = ["--engine", "lax", "--scenario", "lenet", "--attack", "signflip",
            "--nodes", "10", "--ticks", "12", "--topology", "kregular", "--ttl",
            "2", "--compress", "int8", "--out", str(tmp_path / "d.json")]
    reset_launches()
    assert dryrun.main(argv) == 0
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    assert dryrun.main(argv + ["--device", "cpu"]) == 0
    with open(tmp_path / "d.json") as f:
        card, cpu = json.load(f)
    assert card["device"] == "cuda" and cpu["device"] == "cpu"
    counters = ("broadcasts", "deliveries", "fedavg_rounds", "wire_bytes",
                "broadcast_bytes", "delivery_budget", "compact_budget",
                "max_tick_deliveries")
    assert {k: card[k] for k in counters} == {k: cpu[k] for k in counters}
    for k in ("honest_acc", "malicious_reputation"):
        assert abs(card[k] - cpu[k]) <= 0.05, (k, card[k], cpu[k])
    assert launches["quantize"] == launches["dequantize"] == 12


ZOO_NEW = ("recurrentgemma-2b", "chatglm3-6b", "command-r-35b", "dbrx-132b",
           "llama4-maverick-400b-a17b", "xlstm-125m", "hubert-xlarge",
           "llava-next-mistral-7b")
ROUTE_TIE = 2e-2      # tests/test_torch_zoo.py's near tie of two experts


def _step_with_routes(fn):
    """(fn(), [(experts, probs)] of every MoE router call it made), host
    arrays in call order."""
    from repro_torch.models import moe
    calls, route = [], moe._route

    def recorded(p, cfg, x):
        gates, experts, aux = route(p, cfg, x)
        probs = torch.softmax(moe.L.dense_apply(p["router"], x).float(), -1)
        calls.append((experts.cpu().numpy(), probs.cpu().numpy()))
        return gates, experts, aux

    moe._route = recorded
    try:
        return fn(), calls
    finally:
        moe._route = route


def _routed_apart(card, cpu, dtype):
    """Whether the card and the CPU routed a token to other experts in one
    step; each such token must be a near tie, and fp32 must route alike."""
    assert len(card) == len(cpu)
    apart = False
    for (ce, cp), (pe, _) in zip(card, cpu):
        diff = (np.sort(ce, -1) != np.sort(pe, -1)).any(-1)
        for ix in zip(*np.nonzero(diff)):
            gap = abs(np.take(cp[ix], ce[ix]).min() - np.take(cp[ix], pe[ix]).min())
            assert dtype == "bfloat16" and gap <= ROUTE_TIE, (ix, ce[ix], pe[ix], gap)
            apart = True
    return apart


@pytest.mark.parametrize("arch", ("llama3-8b",) + ZOO_NEW)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zoo_smoke_on_the_card_matches_the_cpu(cuda, arch, dtype):
    """smoke_config(arch) from the same params on the card (the simt flash
    kernel at Dh 16, one launch a prefill attention layer, none a decode
    step) and on the CPU (plain): prefill of a ragged prompt and 4 decode
    steps in lockstep, fp32 within rtol/atol 1e-4, bf16 within 5e-2 of the
    logits' scale (xLSTM 2e-2 of it a layer; tests/test_torch_zoo.py's
    bounds); a bf16 MoE step where the two runs routed a token to other
    experts at a near tie is exempt, and fp32 routes alike."""
    from repro_torch import convert, serve
    from repro_torch.configs import smoke_config
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import transformer
    cfg = smoke_config(arch)
    td = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(6)
    params = {"cuda": transformer.init(g, cfg, "cuda")}
    params["cpu"] = convert.params_from_jax(convert.params_to_numpy(params["cuda"]), "cpu")
    inputs = serve.prefill_inputs(cfg, 2, 40, g, "cuda")
    attn_layers = sum(k in ("attn", "local_attn", "enc_attn") for k in cfg.layer_kinds())
    bound = 2e-2 * cfg.num_layers if cfg.family == "ssm" else 5e-2
    caches = {dev: (transformer.cache_init(cfg, 2, 48, dev, dtype=td)
                    if cfg.supports_decode else None) for dev in ("cuda", "cpu")}

    def step(dev, i):          # the prefill (i None) or decode step i's logits
        if i is None:
            return transformer.prefill(params[dev], cfg, {
                k: v.to(dev) for k, v in inputs.items()}, caches[dev], dtype=td)[0]
        return transformer.decode_step(params[dev], cfg, inputs["tokens"][:, -1:].to(dev),
                                       caches[dev], 40 + i, dtype=td)[0]

    for i in [None] + (list(range(4)) if cfg.supports_decode else []):
        logits, routes = {}, {}
        for dev in ("cuda", "cpu"):
            reset_launches()
            lg, routes[dev] = _step_with_routes(lambda: step(dev, i))
            if dev == "cuda":
                torch.cuda.synchronize()
                want = {"flash_attention": attn_layers} if i is None and attn_layers else {}
                assert dict(LAUNCHES) == want, (i, dict(LAUNCHES))
            logits[dev] = lg.cpu().float()
        if _routed_apart(routes["cuda"], routes["cpu"], dtype):
            continue
        if dtype == "float32":
            torch.testing.assert_close(logits["cuda"], logits["cpu"], rtol=1e-4, atol=1e-4)
        else:
            gap = float((logits["cuda"] - logits["cpu"]).abs().max())
            assert gap <= bound * float(logits["cpu"].abs().max()), (i, gap)


@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-maverick-400b-a17b",
                                  "xlstm-125m", "hubert-xlarge"])
def test_leaf_by_leaf_bf16_init_on_the_card(cuda, arch):
    """init(..., dtype=bf16) from a CUDA generator (Philox) is bitwise
    cast_params(init(...), bf16) from the same state: the build that fits
    llama4-maverick's unit on one card."""
    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer
    cfg = smoke_config(arch)
    want = transformer.cast_params(
        transformer.init(torch.Generator(device="cuda").manual_seed(3), cfg, "cuda"),
        torch.bfloat16)
    got = transformer.init(torch.Generator(device="cuda").manual_seed(3), cfg, "cuda",
                           dtype=torch.bfloat16)
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("S,cached", [(130, False), (130, True), (64, True), (40, False)])
def test_slstm_graph_route_is_the_eager_loop(cuda, S, cached):
    """sLSTM prefill on the card replays a captured CUDA graph for each
    run of GRAPH_STEPS steps: bitwise the eager loop (outputs and the
    state it leaves), the remaining steps eager."""
    from repro_torch.configs import smoke_config
    from repro_torch.models import xlstm
    cfg = smoke_config("xlstm-125m")
    g = torch.Generator(device="cuda").manual_seed(S)
    p = xlstm.slstm_init(g, cfg, "cuda")
    x = torch.randn((2, S, cfg.d_model), generator=g, device="cuda").to(torch.bfloat16)
    caches = [xlstm.slstm_state_init(cfg, 2, "cuda") if cached else None for _ in range(2)]
    if cached:      # a state an earlier segment left
        for c in caches:
            xlstm.slstm_apply(p, cfg, x[:, :5], cache=c)
    y, _ = xlstm.slstm_apply(p, cfg, x, cache=caches[0])
    st = caches[1] if cached else xlstm.slstm_state_init(cfg, 2, "cuda")
    hs, last = xlstm._slstm_steps(p, cfg, st, x.float() @ p["w"])
    assert torch.equal(y, xlstm._slstm_out(p, hs, x.dtype))
    if cached:
        for k in last:
            assert torch.equal(caches[0][k], last[k])


# -------------------------------------------------------------- clip and AdamW
ADAMW_HP = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def _adamw_leaf(g, shape, offset=0):
    """g, m, v, p of ``shape`` on the card; ``offset`` > 0 lays each one
    ``offset`` floats past an aligned base (the kernels' one-float path)."""
    n = int(np.prod(shape))

    def draw(scale, positive=False):
        x = torch.randn(n + offset, generator=g, device="cuda") * scale
        return (x.abs() if positive else x)[offset:].view(shape)
    return draw(1e-2), draw(1e-2), draw(1e-4, positive=True), draw(0.02)


# the distinct leaf shapes of chatglm3-6b's benchmark state (17 layers)
GLM_LEAF_SHAPES = [(65024, 4096), (4096,), (17, 4096), (17, 13696, 4096), (17, 13696),
                   (17, 4096, 13696), (17, 2, 128), (17, 4096, 2, 128),
                   (17, 32, 128, 4096), (17, 32, 128), (17, 4096, 32, 128)]


def _glm_leaf_shapes():
    """Every leaf shape of chatglm3-6b's benchmark state, in tree order."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    cfg = dataclasses.replace(get_config("chatglm3-6b"), num_layers=17)
    return [tuple(x.shape) for x in tree.leaves(transformer.init(None, cfg, "meta"))]


@pytest.mark.parametrize("shape,offset", [((7,), 0), ((1,), 0), ((1001, 3), 0),
                                          ((17, 13696, 64), 0), ((257, 9), 1)]
                         + [(shape, 0) for shape in GLM_LEAF_SHAPES])
@pytest.mark.parametrize("step,clip", [(0, True), (3, False), (3, True)])
def test_adamw_step_kernel_bitwise_vs_plain(cuda, shape, offset, step, clip):
    """m, v and p bitwise the plain version given the kernel's clip scale
    (engaged or not), on small and ragged leaves and on every leaf shape of
    chatglm3-6b's benchmark state; g read only; one launch a leaf."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.adamw import ops, ref
    from repro_torch.optim import schedules
    g = torch.Generator(device="cuda").manual_seed(step * 7 + len(shape))
    grad, m, v, p = _adamw_leaf(g, shape, offset)
    norm, scale = ops.grad_norm([grad], 1e-3 if clip else 1e6)
    assert (float(scale) < 1.0) == clip
    s = torch.tensor(step, dtype=torch.int32, device=cuda)
    lr = schedules.warmup_cosine(3e-4, 2, 100)(s)
    t = s.to(torch.float32) + 1.0
    bc1, bc2 = 1.0 - ADAMW_HP["b1"] ** t, 1.0 - ADAMW_HP["b2"] ** t
    want = [x.clone() for x in (grad, m, v, p)]
    g0, p0 = grad.clone(), p.clone()
    reset_launches()
    ops.adamw_step(grad, m, v, p, scale, lr, bc1, bc2, **ADAMW_HP)
    torch.cuda.synchronize()
    assert LAUNCHES["adamw_step"] == 1
    ref.adamw_step(*want, scale, lr, bc1, bc2, **ADAMW_HP)
    assert torch.equal(grad, g0)
    for name, a, b in zip("mvp", (m, v, p), want[1:]):
        assert torch.equal(a, b), name
    assert not torch.equal(p, p0)                 # the update moved p


@pytest.mark.parametrize("state", ["mixed", "chatglm3-6b"])
def test_grad_sumsq_kernel_vs_fp64_and_repeats(cuda, state):
    """The norm within 1e-6 of the fp64 norm, the scale the plain formula's
    given that norm, both bitwise over two calls; a launch a non-empty leaf
    and the final one. Over small, empty and misaligned leaves, and over
    chatglm3-6b's benchmark state (19 leaves, 4.0 B params)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.adamw import ops
    from repro_torch.optim import optimizers as opt_lib
    g = torch.Generator(device="cuda").manual_seed(3)
    if state == "mixed":
        shapes = [(7,), (1,), (0, 4), (1001, 3), (17, 13696, 64), (4097,)]
    else:
        shapes = _glm_leaf_shapes()
    leaves = [torch.randn(s, generator=g, device="cuda") for s in shapes]
    if state == "mixed":
        leaves.append(torch.randn(1 + 5000, generator=g, device="cuda")[1:])   # misaligned
    want = float(torch.sqrt(sum(x.double().square().sum() for x in leaves)))
    reset_launches()
    norm, scale = ops.grad_norm(leaves, 1.0)
    torch.cuda.synchronize()
    # a launch a non-empty leaf, and the final one
    assert LAUNCHES["grad_sumsq"] == sum(x.numel() > 0 for x in leaves) + 1
    assert abs(float(norm) / want - 1) <= 1e-6
    assert torch.equal(scale, opt_lib.clip_scale(norm, 1.0)) and float(scale) < 1.0
    again = ops.grad_norm(leaves, 1.0)
    assert torch.equal(again[0], norm) and torch.equal(again[1], scale)
    _, big = ops.grad_norm(leaves, 1e9)
    assert float(big) == 1.0


def test_adamw_wrappers_reject_what_the_kernels_do_not_take(cuda):
    from repro_torch.kernels.adamw import ops
    x = torch.zeros(4, 6, device=cuda)
    s = torch.ones((), device=cuda)
    with pytest.raises(TypeError):
        ops.adamw_step(x, x.clone(), x.clone(), x.to(torch.bfloat16), s, s, s, s, **ADAMW_HP)
    with pytest.raises(ValueError):
        ops.adamw_step(x.t().contiguous().t(), x.clone(), x.clone(), x.clone(), s, s, s, s,
                       **ADAMW_HP)
    with pytest.raises(ValueError):
        ops.adamw_step(x, x.clone(), x.clone(), x.clone(), s, s.cpu(), s, s, **ADAMW_HP)
    with pytest.raises(TypeError):
        ops.grad_norm([x, x.to(torch.bfloat16)], 1.0)
    with pytest.raises(ValueError):
        ops.grad_norm([x.t()], 1.0)


@pytest.mark.parametrize("arch", ["llama3-8b", "trinity-mini"])
def test_train_step_adamw_kernels_are_the_plain_path_on_the_card(cuda, arch):
    """Two steps of ``make_train_step`` (a dense config, and the dropless
    MoE config with its expert bias) through the kernels, against the plain
    clip-and-AdamW run on the same CUDA grads given the kernel's norm:
    params and state bitwise; one ``adamw_step`` launch a leaf a step."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.adamw import ref
    from repro_torch.optim import optimizers as opt_lib
    from repro_torch.train import step
    cfg = smoke_config(arch)
    if arch == "llama3-8b":
        cfg = dataclasses.replace(cfg, head_dim=64, d_model=256)
    opt = step.make_optimizer(cfg)
    seen = []

    def watched(grads, state, params, s, max_norm):
        gl = [x.clone() for x in tree.leaves(grads)]
        out = opt.apply(grads, state, params, s, max_norm)
        seen.append((gl, out[2].clone()))
        return out

    ts = step.make_train_step(cfg, dataclasses.replace(opt, apply=watched))
    state = step.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  opt=opt, device="cuda")
    plain = {"params": tree.map(torch.clone, state["params"]),
             "m": tree.map(torch.clone, state["opt"]["m"]),
             "v": tree.map(torch.clone, state["opt"]["v"])}
    pipe = TokenPipeline(cfg.vocab_size, 2, 128)
    leaves = sum(x.numel() > 0 for x in tree.leaves(state["params"]))
    reset_launches()
    for k in range(2):
        batch = {key: torch.as_tensor(x, device="cuda")
                 for key, x in pipe.batch_at(k).items()}
        s = state["step"].clone()
        state, metrics = ts(state, batch)
        grads, norm = seen[-1]
        assert torch.equal(metrics["grad_norm"], norm)
        want = float(opt_lib.global_norm(grads))
        assert abs(float(norm) / want - 1) <= 1e-6
        scale = opt_lib.clip_scale(norm, 1.0)
        lr = step.make_lr_fn(cfg)(s)
        t = s.to(torch.float32) + 1.0
        bc1, bc2 = 1.0 - ADAMW_HP["b1"] ** t, 1.0 - ADAMW_HP["b2"] ** t
        for g_, m, v, p in zip(grads, *(tree.leaves(plain[k_]) for k_ in ("m", "v", "params"))):
            ref.adamw_step(g_, m, v, p, scale, lr, bc1, bc2, **ADAMW_HP)
        for name, got, ref_ in (("params", state["params"], plain["params"]),
                                ("m", state["opt"]["m"], plain["m"]),
                                ("v", state["opt"]["v"], plain["v"])):
            for a, b in zip(tree.leaves(got), tree.leaves(ref_)):
                assert torch.equal(a, b), (arch, k, name)
    torch.cuda.synchronize()
    assert LAUNCHES["adamw_step"] == 2 * leaves
    assert LAUNCHES["grad_sumsq"] == 2 * (leaves + 1)
