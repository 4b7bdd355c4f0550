"""The port's CUDA kernels on the card, against their plain versions.

Marked ``gpu``: they need an NVIDIA GPU and ``nvcc`` and skip elsewhere
(a CUDA kernel has no CPU or interpret mode; the CPU tests hold the plain
versions to the JAX package). Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(25, 6), (150, 16), (784, 120), (120, 84),
                                   (84, 10), (1, 120), (1001, 256), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_pair_bitwise_vs_plain(cuda, shape, dtype):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.quantize import ops
    from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref
    g = torch.Generator().manual_seed(shape[0] * shape[1])
    x = (torch.randn(shape, generator=g) * 3.0).to(cuda, getattr(torch, dtype))
    reset_launches()
    q, s = ops.quantize_rows(x)
    qr, sr = quantize_ref(x)
    assert torch.equal(q, qr) and torch.equal(s, sr)
    assert torch.equal(ops.dequantize_rows(q, s), dequantize_ref(q, s))
    torch.cuda.synchronize()
    assert LAUNCHES["quantize"] == 1 and LAUNCHES["dequantize"] == 1


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
# name -> [(shape, dtype)] in tree order; "misaligned" lays every leaf 4
# bytes past a 16-byte aligned base (the scalar path for all of them)
QUANTIZE_TREES = {
    "lenet": [((6,), _F32), ((5, 5, 1, 6), _F32), ((16,), _F32),
              ((5, 5, 6, 16), _F32), ((120,), _F32), ((784, 120), _F32),
              ((84,), _F32), ((120, 84), _F32), ((10,), _F32), ((84, 10), _F32)],
    "odd": [((), _F32), ((4, 0), _F32), ((0, 5), _F32), ((6,), _F32)],
    "ragged": [((5, 300), _F32), ((2, 3, 520), _F32), ((3, 257), _F32),
               ((1001, 256), _F32)],
    "bf16": [((120,), _BF16), ((784, 120), _BF16), ((4, 520), _BF16),
             ((84, 10), _BF16)],
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
        if name == "misaligned":
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


@pytest.mark.parametrize("n,d,offset", [(10, 94080, 0), (10, 10080, 0),
                                        (10, 10081, 0), (3, 4100, 1)])
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


@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window", [
    (1, 512, 32, 8, 128, True, 0),       # llama3's heads
    (1, 512, 16, 8, 256, True, 128),     # gemma3's local heads, a window
    (2, 200, 4, 2, 64, False, 0),        # bidirectional, ragged
    (1, 77, 4, 1, 80, True, 0),          # KH = 1, Dh padded to 128
    (1, 130, 4, 4, 16, True, 0),         # KH = H, the smoke head dim
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_kernel_vs_plain(cuda, B, S, H, KH, Dh, causal, window,
                                         dtype):
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    g = torch.Generator().manual_seed(S * H + Dh)
    td = getattr(torch, dtype)
    q = torch.randn((B, S, H, Dh), generator=g).to(cuda, td)
    k = torch.randn((B, S, KH, Dh), generator=g).to(cuda, td)
    v = torch.randn((B, S, KH, Dh), generator=g).to(cuda, td)
    reset_launches()
    out = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1 and out.dtype == td
    want = attention_ref(q, k, v, causal=causal, window=window)
    tol = 1e-5 if dtype == "float32" else 1.6e-2
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


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


@pytest.mark.parametrize("Dh", [64, 128, 256])
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
@pytest.mark.parametrize("B,S,H,KH,Dh,causal,window,dtype,route", [
    (1, 1024, 8, 2, 128, True, 0, "bfloat16", "sm90"),
    (1, 1000, 8, 2, 64, True, 128, "bfloat16", "sm90"),
    (1, 512, 4, 2, 256, False, 0, "bfloat16", "sm90"),
    (2, 100, 4, 2, 16, True, 0, "float32", "simt"),
    (2, 100, 4, 2, 16, True, 32, "bfloat16", "simt"),
    (1, 20, 2, 1, 8, True, 4, "float32", "simt"),
])
def test_flash_lse_and_backward_vs_plain(cuda, B, S, H, KH, Dh, causal, window,
                                         dtype, route):
    """Both kernels write the plain version's log-sum-exp (abs 2e-5 on
    values of ~5-10, chip_smoke's bound; -1e38 for a row without kept
    keys), and the model's recompute backward on the kernel's lse matches
    autograd through the plain version within the bf16 rounding of p, dout
    and ds (relative L2 1e-2, chip_smoke's bound)."""
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import flash
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(S + Dh)
    q = torch.randn((B, S, H, Dh), generator=g, device="cuda").to(dt)
    k, v = (torch.randn((B, S, KH, Dh), generator=g, device="cuda").to(dt)
            for _ in range(2))
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
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=2e-5)
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


def test_train_step_through_kernels_matches_plain_route(cuda):
    """One smoke-size llama3-8b step (bf16 activations) through the kernels
    and with the attention forced through the plain version: loss within
    2e-2, grads within 2e-2 relative L2 a leaf (chip_smoke's bound at full
    width); the kernel launched twice a
    layer (forward, remat recompute), the plain route never."""
    import dataclasses

    from repro_torch import tree
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import TokenPipeline
    from repro_torch.kernels import LAUNCHES, reset_launches
    from repro_torch.models import flash
    from repro_torch.train import step
    cfg = dataclasses.replace(smoke_config("llama3-8b"), head_dim=64,
                              d_model=256)     # Dh 64: the sm90 kernel
    state = step.init_train_state(cfg, torch.Generator(device="cuda").manual_seed(0),
                                  device="cuda")
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in TokenPipeline(cfg.vocab_size, 2, 256).batch_at(0).items()}
    reset_launches()
    loss_k, _, g_k = step.loss_and_grads(state["params"], cfg, batch)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention_sm90"] == 2 * cfg.num_layers
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
