"""The dry-run cell report (``repro_torch.launch.dryrun --engine mesh``)
held to the JAX package's ``lower_cell`` records on the CPU.

JAX's records come from one fresh interpreter for the file (conftest's
``subprocess_runner``, 8 forced host devices): llama3-8b, dbrx-132b and
recurrentgemma-2b at their smoke configs on ``make_test_mesh(2, 2)`` for
train_4k, prefill_32k and decode_32k, and llama3-8b's gossip round on
``make_fed_mesh(2, 1, 2)``. The port traces the same cells on the meta
device over the abstract meshes of the same names and sizes.

Bounds (the contract of the cell record):
  * params, model_flops_global, argument bytes and the round's permute
    bytes: exact;
  * FLOPs a device: serve cells and the round within 10%, train within a
    factor of 1.5. JAX's prefill forward (``flash.py``'s non-triangle path)
    visits every (query block, key block) pair and masks the ones above
    the diagonal; the port's flash kernel skips them. So a prefill cell
    with global causal attention is held to JAX's FLOPs less that masked
    work (4 Dh + 2 FLOPs a masked pair: its two products and two row
    reductions, computed from JAX's own block loop); its raw ratio is
    about 0.49 (PERF.md);
  * collective bytes a device (all kinds): within a factor of 2;
  * ``dominant`` under JAX's v5e figures (passed as ``hw``): JAX's, but in
    the three cells where JAX's memory term is its host lowering's
    (``DOMINANT_DIFFERS``: the jnp flash scan writes each block's fp32
    scores and carries, 34-500 x the port's bytes), where the port's is
    another term and the test holds that cause;
  * useful FLOP ratio: a train cell's in (0, 1]; the round's within 10% of
    JAX's (both well above 1: one round against the train shape's 6ND).
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch import kernels, tree                     # noqa: E402
from repro_torch.configs import SHAPES, get_config, smoke_config  # noqa: E402
from repro_torch.core import compression, tracecheck      # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops     # noqa: E402
from repro_torch.launch import dryrun, mesh as mesh_lib, op_cost, report  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
V5E = {"peak_flops": 197e12, "hbm_bw": 819e9, "ici_bw": 50e9}  # JAX's figures
CELLS = [f"{a}/{s}" for a in ("llama3-8b", "dbrx-132b", "recurrentgemma-2b")
         for s in ("train_4k", "prefill_32k", "decode_32k")] + ["llama3-8b/dfl"]
DOMINANT_DIFFERS = {"llama3-8b/prefill_32k", "dbrx-132b/prefill_32k", "llama3-8b/dfl"}
EXTRA_KEYS = {"device", "hw"}

_JAX_CODE = """
import dataclasses, json, sys
from repro.launch import dryrun
from repro.launch.mesh import make_fed_mesh, make_test_mesh
from repro.configs import smoke_config
from repro.core.dfl import DFLConfig
out = {}
for cell in json.loads(sys.argv[1]):
    arch, shape = cell.split("/")
    s = smoke_config(arch)
    ov = {f.name: getattr(s, f.name) for f in dataclasses.fields(s) if f.name != "name"}
    if shape == "dfl":
        rec, _, _ = dryrun.lower_cell(arch, "train_4k", mesh=make_fed_mesh(2, 1, 2),
                                      cfg_overrides=ov, dfl=True, dfl_cfg=DFLConfig())
    else:
        rec, _, _ = dryrun.lower_cell(arch, shape, mesh=make_test_mesh(2, 2),
                                      cfg_overrides=ov)
    out[cell] = rec
print("RESULT " + json.dumps(out, default=str))
"""

_JAX, _PORT = {}, {}


def _jax(subprocess_runner):
    if not _JAX:
        proc = subprocess_runner(
            f"import sys\nsys.argv = ['-c', {json.dumps(CELLS)!r}]\n" + _JAX_CODE,
            host_devices=8)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        assert proc.returncode == 0 and lines, proc.stderr[-4000:]
        _JAX.update(json.loads(lines[-1][len("RESULT "):]))
    return _JAX


def _overrides(arch):
    s = smoke_config(arch)
    return {f.name: getattr(s, f.name) for f in dataclasses.fields(s)
            if f.name != "name"}


def _port(cell):
    if cell not in _PORT:
        arch, shape = cell.split("/")
        if shape == "dfl":
            _PORT[cell] = dryrun.lower_cell(
                arch, "train_4k", mesh=mesh_lib.abstract_fed_mesh(2, 1, 2),
                cfg_overrides=_overrides(arch), dfl=True, hw=V5E)
        else:
            _PORT[cell] = dryrun.lower_cell(
                arch, shape, mesh=mesh_lib.abstract_test_mesh(2, 2),
                cfg_overrides=_overrides(arch), hw=V5E)
    return _PORT[cell][0]


def _jax_masked_block_flops(cell) -> float:
    """FLOPs a device JAX's prefill forward spends on (query, key) pairs
    above the diagonal: its non-triangle path visits the whole S x S
    rectangle of every global causal layer."""
    arch, shape_name = cell.split("/")
    shape = SHAPES.get(shape_name)
    if shape is None or shape.kind != "prefill":
        return 0.0
    cfg = smoke_config(arch)
    rows, S = shape.global_batch // 2, shape.seq_len     # batch over data 2
    masked = S * S - S * (S + 1) // 2
    n_global = sum(k == "attn" for k in cfg.layer_kinds())
    per_pair = 4 * cfg.resolved_head_dim + 2
    return n_global * per_pair * rows * cfg.num_heads * masked / 2  # model 2


@pytest.mark.parametrize("cell", CELLS)
def test_params_model_flops_and_argument_bytes_are_exact(cell, subprocess_runner):
    j, p = _jax(subprocess_runner)[cell], _port(cell)
    assert (p["status"], j["status"]) == ("ok", "ok")
    assert p["params"] == j["params"]
    assert p["model_flops_global"] == j["model_flops_global"]
    assert p["bytes_per_device"]["argument"] == j["bytes_per_device"]["argument"]
    assert (p["mesh"], p["chips"], p["mesh_axes"]) == (j["mesh"], j["chips"],
                                                      j["mesh_axes"])
    if cell.endswith("dfl"):
        assert p["permute_bytes"] == j["permute_bytes"]
    assert set(j) <= set(p) and set(p) - set(j) == EXTRA_KEYS
    assert set(j["roofline"]) == set(p["roofline"])
    assert all(v is not None for v in p["bytes_per_device"].values())
    b = p["bytes_per_device"]
    assert b["peak"] == b["argument"] + b["temp"] and b["temp"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_flops_a_device_against_jax(cell, subprocess_runner):
    j, p = _jax(subprocess_runner)[cell], _port(cell)
    want = j["roofline"]["hlo_flops"] - _jax_masked_block_flops(cell)
    ratio = p["roofline"]["hlo_flops"] / want
    if "train_4k" in cell:
        assert 1 / 1.5 <= ratio <= 1.5, ratio
    else:
        assert 0.9 <= ratio <= 1.1, ratio


@pytest.mark.parametrize("cell", CELLS)
def test_collective_bytes_within_a_factor_of_two(cell, subprocess_runner):
    j, p = _jax(subprocess_runner)[cell], _port(cell)
    ratio = p["roofline"]["collective_bytes"] / j["roofline"]["collective_bytes"]
    assert 0.5 <= ratio <= 2.0, (ratio, p["roofline"]["collective_bytes_by_op"],
                                 j["roofline"]["collective_bytes_by_op"])


@pytest.mark.parametrize("cell", CELLS)
def test_dominant_term_under_v5e(cell, subprocess_runner):
    j, p = _jax(subprocess_runner)[cell], _port(cell)
    rf = p["roofline"]
    assert rf["dominant"] in ("compute", "memory", "collective")
    assert rf["dominant"] == max(("compute", "memory", "collective"),
                                 key=lambda k: rf[f"{k}_s"])
    if cell not in DOMINANT_DIFFERS:
        assert rf["dominant"] == j["roofline"]["dominant"]
    else:
        # JAX's memory term is its lowering's materialized attention blocks
        assert j["roofline"]["dominant"] == "memory" != rf["dominant"]
        assert j["roofline"]["hlo_bytes"] >= 20 * rf["hlo_bytes"]


@pytest.mark.parametrize("cell", [c for c in CELLS if "train" in c or "dfl" in c])
def test_useful_flops_ratio(cell, subprocess_runner):
    j, p = _jax(subprocess_runner)[cell], _port(cell)
    if cell.endswith("dfl"):
        assert j["useful_flops_ratio"] > 1
        assert abs(p["useful_flops_ratio"] / j["useful_flops_ratio"] - 1) <= 0.1
    else:
        assert 0 < p["useful_flops_ratio"] <= 1


# ------------------------------------------------------------------ trip counts
@pytest.mark.parametrize("arch,shape_name,units", [
    ("llama3-8b", "train_4k", 4), ("recurrentgemma-2b", "prefill_32k", 3),
    ("xlstm-125m", "train_4k", 3)])
def test_extrapolated_counts_equal_a_full_trace(arch, shape_name, units):
    """1- and 2-unit traces (and two sequence lengths for the sLSTM loop)
    extrapolated to the config's depth and length give a full trace's
    counts."""
    base = smoke_config(arch)
    ul = len(base.block_pattern)
    cfg = base.scaled(num_layers=units * ul)
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=64, global_batch=4)
    mesh = mesh_lib.abstract_test_mesh(2, 2)
    rules = dryrun.step_lib.rules_for(cfg, shape)
    got, _, trips = dryrun.traced_counts(cfg, shape, mesh, rules)
    want, _, _ = dryrun.traced_counts(cfg, shape, mesh, rules, full=True)
    assert trips[0] == units
    if arch == "xlstm-125m":
        assert trips[1] == 64
    for key in ("flops", "bytes"):
        assert got[key] == pytest.approx(want[key], rel=1e-9), key
    assert got["kernel_calls"] == pytest.approx(want["kernel_calls"])
    assert got["flops"] > 0


def test_extrapolated_round_collectives_equal_a_full_trace():
    cfg = smoke_config("llama3-8b").scaled(num_layers=3)
    shape = SHAPES["train_4k"]
    mesh = mesh_lib.abstract_fed_mesh(4, 1, 2)
    d = dryrun.dfl_lib.DFLConfig(topology="kregular", ttl=2, val_seq=64)
    rules = dryrun.dfl_lib.gossip_rules(cfg, "fed")
    got, _, _ = dryrun.traced_counts(cfg, shape, mesh, rules, dfl=d)
    want, _, _ = dryrun.traced_counts(cfg, shape, mesh, rules, dfl=d, full=True)
    assert got["collective_bytes"] == pytest.approx(want["collective_bytes"])
    assert got["collective_count"] == pytest.approx(want["collective_count"])
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-9)


# ------------------------------------------------------------------ meta branch
def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_flash_meta_reports_the_band_and_reaches_nothing(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on meta")

    monkeypatch.setattr(flash_ops, "attention_ref", boom)
    monkeypatch.setattr(kernels.build, "load", boom)
    kernels.reset_launches()
    B, S, H, KH, Dh, W = 2, 96, 4, 2, 128, 32
    q, k, v = _meta(B, S, H, Dh), _meta(B, S, KH, Dh), _meta(B, S, KH, Dh)
    with op_cost.OpCost() as w:
        out, lse = flash_ops.flash_attention(q, k, v, causal=True, window=W,
                                             return_lse=True)
        full = flash_ops.flash_attention(q, k, v, causal=False)
    assert out.is_meta and tuple(out.shape) == (B, S, H, Dh)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert tuple(lse.shape) == (B, H, S) and tuple(full.shape) == (B, S, H, Dh)
    band = sum(min(i + 1, W) for i in range(S))
    assert w.by_op["kernel:flash_attention_sm90"][1] == 4 * B * H * Dh * (band + S * S)
    nbytes = 2 * (2 * B * S * H * Dh + 2 * B * S * KH * Dh)
    assert w.by_op["kernel:flash_attention_sm90"][2] == 2 * nbytes + 4 * B * H * S
    assert w.kernel_calls == {"flash_attention_sm90": 2}
    assert not kernels.LAUNCHES
    # fp32 (or another head dim) names the simt kernel's route
    with op_cost.OpCost() as w:
        flash_ops.flash_attention(_meta(1, 8, 2, 16, dtype=torch.float32),
                                  *(_meta(1, 8, 2, 16, dtype=torch.float32),) * 2)
    assert w.kernel_calls == {"flash_attention": 1}
    assert flash_ops.kept_pairs(8, 8, True, 0) == 36
    assert flash_ops.kept_pairs(8, 8, False, 3) == sum(min(8, i + 3) for i in range(8))


def test_quantize_meta_reports_the_trees_bytes(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on meta")

    for name in ("quantize_tree_ref", "dequantize_tree_ref", "roundtrip_tree_ref",
                 "quantize_ref", "dequantize_ref"):
        monkeypatch.setattr(q_ops, name, boom)
    monkeypatch.setattr(kernels.build, "load", boom)
    kernels.reset_launches()
    tree_ = {"a": _meta(4, 300, dtype=torch.float32), "b": _meta(7, dtype=torch.bfloat16)}
    with op_cost.OpCost() as w:
        qt, spec = compression.quantize_tree(tree_)
        back = compression.dequantize_tree(qt, spec)
        rt = compression.roundtrip_tree(tree_)
        q, s = q_ops.quantize_rows(_meta(5, 64, dtype=torch.float32))
        x = q_ops.dequantize_rows(q, s)
    wire = compression.payload_bytes(tree_, "int8")
    leaves = 4 * 300 * 4 + 7 * 2
    assert [tuple(x.shape) for x in tree.leaves(back)] == [(4, 300), (7,)]
    assert [t.dtype for t in tree.leaves(rt)] == [torch.float32, torch.bfloat16]
    rows = 5 * 64 * 4 + 5 * 64 + 5 * 4        # fp32 rows, int8 q, fp32 scales
    assert w.by_op["kernel:quantize"][2] == 2 * (leaves + wire) + rows
    assert w.by_op["kernel:dequantize"][2] == 2 * (wire + leaves) + rows
    assert w.kernel_calls == {"quantize": 3, "dequantize": 3}
    assert x.is_meta and tuple(x.shape) == (5, 64) and not kernels.LAUNCHES


def test_cpu_inputs_still_take_the_plain_versions(monkeypatch):
    calls = []
    real = flash_ops.attention_ref
    monkeypatch.setattr(flash_ops, "attention_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    q = torch.randn(1, 8, 2, 16)
    flash_ops.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert calls == [1]
    x = {"w": torch.randn(3, 40)}
    assert torch.equal(compression.roundtrip_tree(x)["w"],
                       q_ops.roundtrip_tree_ref([x["w"]], q_ops.BLOCK_COLS)[0])
    kernels.reset_launches()
    assert not kernels.LAUNCHES


def test_walker_counts_live_storages_once():
    with op_cost.OpCost() as w:
        a = torch.empty(1024, device="meta")
        v = a.view(32, 32)          # a view: same storage
        b = v * 2                   # 4 KiB more
        del a, v
        c = b + 1                   # a's storage is gone by now
    assert w.peak_live == 2 * 4096 and w.live == 2 * 4096
    assert w.by_op["mul"][2] == 2 * 4096 and w.by_op["view"][2] == 0
    assert c.is_meta


# ------------------------------------------------------------ report and CLI
def test_report_renders_port_and_jax_records(subprocess_runner):
    jax_recs = list(_jax(subprocess_runner).values())
    port_recs = [_port(c) for c in CELLS]
    skip = {"arch": "hubert-xlarge", "shape": "decode_32k", "status": "skip",
            "reason": "encoder-only arch has no decode step"}
    err = {"arch": "x", "shape": "y", "mesh": "16x16", "status": "error",
           "error": "ValueError: boom"}
    for recs in (jax_recs, port_recs):
        table = report.dryrun_table(recs + [skip, err])
        assert table.count("\n") == len(recs) + 3 and "SKIP" in table
        roof = report.roofline_table(recs)
        assert roof.count("\n") == 1 + len(recs) - 1   # the dfl record left out
    assert "(>80G)" in report._fits({"bytes_per_device": {"argument": 81e9,
                                                          "temp": 0}})


def _cli(argv, tmp_path, name="cells.json"):
    out = tmp_path / name
    rc = dryrun.main([*argv, "--out", str(out)])
    with open(out) as f:
        return rc, json.load(f)


def test_cli_writes_records_with_the_jax_keys(tmp_path, subprocess_runner, capsys):
    rc, recs = _cli(["--arch", "llama3-8b", "--shape", "train_4k", "--print-hlo"],
                    tmp_path)
    (p,) = recs
    j = _jax(subprocess_runner)["llama3-8b/train_4k"]
    assert rc == 0 and set(p) - set(j) == EXTRA_KEYS and set(j) <= set(p)
    assert (p["device"], p["mesh"], p["chips"], p["compile_s"]) == ("meta", "16x16",
                                                                     256, 0.0)
    assert p["hw"]["name"].startswith("NVIDIA H100")
    assert 0 < p["useful_flops_ratio"] <= 1
    assert p["roofline"]["scan_trip_counts"] == [32]
    out = capsys.readouterr().out
    assert "traced in" in out and "kernel:flash_attention_sm90" in out
    # a second run finds the cell cached under the JAX key
    rc, recs = _cli(["--arch", "llama3-8b", "--shape", "train_4k"], tmp_path)
    assert rc == 0 and len(recs) == 1
    assert "cached, skipping" in capsys.readouterr().out


def test_all_caches_by_the_jax_key(tmp_path, capsys):
    from repro_torch.configs import ARCH_IDS
    seeded = [{"arch": a, "shape": s, "mesh": "16x16", "dfl": False,
               "topology": None, "status": "ok"} for a in ARCH_IDS for s in SHAPES]
    seeded[-1] = {"arch": ARCH_IDS[-1], "shape": "long_500k", "status": "skip",
                  "reason": "x"}
    with open(tmp_path / "all.json", "w") as f:
        json.dump(seeded, f)
    rc, recs = _cli(["--all"], tmp_path, "all.json")
    assert rc == 0 and recs == seeded
    assert capsys.readouterr().out.count("cached, skipping") == len(seeded)


def test_dfl_cli_record_and_int8_payloads(tmp_path):
    rc, (rec,) = _cli(["--arch", "llama3-8b", "--shape", "train_4k", "--dfl",
                       "--topology", "smallworld", "--ttl", "2", "--compress",
                       "int8"], tmp_path)
    assert rc == 0 and rec["dfl"] and rec["step_kind"] == "gossip"
    sched = rec["gossip_schedule"]
    assert (sched["topology"], sched["ttl"], sched["coverage"]) == ("smallworld", 2, 1.0)
    assert rec["roofline"]["collectives"]["collective-permute"] == sched["num_collectives"]
    assert rec["compress"] == "int8" and rec["permute_bytes"] > 0
    # int8 payloads: about a quarter of the fp32 round's
    rc, (fp32,) = _cli(["--arch", "llama3-8b", "--shape", "train_4k", "--dfl",
                        "--topology", "smallworld", "--ttl", "2"], tmp_path, "f.json")
    assert 0.2 < rec["permute_bytes"] / fp32["permute_bytes"] < 0.3
    assert rec["useful_flops_ratio"] > 1


def test_dfl_on_a_serve_shape_is_an_error_record(tmp_path):
    rc, (rec,) = _cli(["--arch", "llama3-8b", "--shape", "decode_32k", "--dfl"],
                      tmp_path)
    assert rc == 1 and rec["status"] == "error"
    assert "training shapes" in rec["error"]


def test_skip_cells_and_usage_error(tmp_path, capsys):
    rc, (rec,) = _cli(["--arch", "hubert-xlarge", "--shape", "decode_32k"], tmp_path)
    assert rc == 0 and rec == {"arch": "hubert-xlarge", "shape": "decode_32k",
                               "status": "skip",
                               "reason": "encoder-only arch has no decode step"}
    with pytest.raises(SystemExit) as e:
        dryrun.main([])
    assert e.value.code == 2
    assert "--arch/--shape or --all required" in capsys.readouterr().err


def test_report_main_reads_the_record_files(tmp_path, capsys):
    rec, _ = dryrun.lower_cell("llama3-8b", "decode_32k")
    with open(tmp_path / "dryrun_single_pod.json", "w") as f:
        json.dump([rec], f)
    report.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "| llama3-8b | decode_32k | 16x16 | ok |" in out
    assert "H100" in out and "memory-bound" in out


def test_report_runs_as_a_module(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                           "--dir", str(tmp_path)], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0 and "Roofline" in proc.stdout


# ------------------------------------------------------------------ tracecheck
class _FakeGraph:
    def __init__(self, *a, **k):
        pass

    def replay(self):
        pass


class _FakeStream:
    def __init__(self, *a, **k):
        pass

    def wait_stream(self, other):
        pass


def _stub_graphs(monkeypatch):
    import contextlib
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda g: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", _FakeStream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())


def test_sgd_graph_captures_once_a_shape(monkeypatch):
    from repro_torch.chain import scenarios
    _stub_graphs(monkeypatch)
    monkeypatch.setattr(scenarios, "_graphed", lambda rows: True)
    counter = tracecheck.get_counter("chain.scenarios.sgd_graph")
    counter.reset()
    sc = scenarios.get("lenet")(4, train_steps=1, pool=16, eval_size=8,
                                test_size=16, batch=4)
    params = sc.init_params_stacked("cpu")
    data = sc.train_data("cpu")
    idx = torch.zeros((2, 1, sc.batch), dtype=torch.long)
    for rows in (torch.tensor([0, 1]), torch.tensor([2, 3])):
        models = tree.map(lambda x, r=rows: x[r], params)
        sc.sgd_stacked(models, data, rows, idx)
    assert counter.count == 1                 # two same-shape calls
    rows3 = torch.tensor([0, 1, 2])
    sc.sgd_stacked(tree.map(lambda x: x[rows3], params), data, rows3,
                   torch.zeros((3, 1, sc.batch), dtype=torch.long))
    assert counter.count == 2                 # a new model count captures again


def test_step_graph_captures_once_a_shape_and_asserts(monkeypatch):
    from repro_torch.models import xlstm
    _stub_graphs(monkeypatch)
    counter = tracecheck.get_counter("models.xlstm.step_graph")
    counter.reset()
    xlstm._step_graph.cache_clear()
    cfg = smoke_config("xlstm-125m")
    g = xlstm._step_graph(cfg, 2, torch.device("cpu"))
    assert xlstm._step_graph(cfg, 2, torch.device("cpu")) is g
    assert counter.count == 1
    xlstm._step_graph(cfg, 3, torch.device("cpu"))
    assert counter.count == 2
    xlstm._step_graph.cache_clear()

    @tracecheck.assert_max_captures(n=1, name="test.capture")
    def capture(shape):
        return shape

    capture((1,))
    with pytest.raises(RuntimeError, match="captured 2 times"):
        capture((2,))
    assert tracecheck.get_counter("test.capture").count == 2


def test_cells_run_at_full_size_on_meta():
    cfg = get_config("llama3-8b")
    rec, counts = dryrun.cell_record(
        cfg.scaled(num_layers=4), dataclasses.replace(SHAPES["train_4k"],
                                                      global_batch=2),
        mesh_lib.AbstractMesh(("data", "model"), (1, 1)))
    # 12 param leaves: an AdamW launch each, a partial norm each and the final
    assert counts["kernel_calls"] == {"flash_attention_sm90": 8, "adamw_step": 12,
                                      "grad_sumsq": 13}
    assert rec["roofline"]["collective_bytes"] == 0.0
    assert rec["roofline"]["dominant"] in ("compute", "memory")
