"""The plain references against the program at tiny sizes, on the CPU (the
test imports both; the references import nothing of the program)."""
import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.gen import glm_weights, lenet_data, tokens
from perfbench.reference import federation as fed_ref
from perfbench.reference import glm as glm_ref
from perfbench.reference import lenet as lenet_ref
from perfbench.tests import _small

torch.set_num_threads(4)
CFG = json.loads((harness.ROOT / "perfbench/configs/lenet5-dfl.json").read_text())


def test_lenet_sgd_and_accuracy_match_the_program():
    from repro_torch.chain import scenarios
    from repro_torch.models import lenet
    model, recipe = CFG["model"], dict(CFG["recipe"], pool=32, eval_size=8, test_size=16)
    n = 4
    inputs = lenet_data.draw_inputs(recipe, model, n, 3, "cpu")
    params = lenet_data.draw_params(model, n, 3, "cpu")
    sc = scenarios.LeNetScenario(
        class_probs=None, train_images=inputs["train_images"],
        train_labels=inputs["train_labels"], eval_images=inputs["eval_images"],
        eval_labels=inputs["eval_labels"], test_images=inputs["test_images"],
        test_labels=inputs["test_labels"], malicious=(), train_steps=3, batch=16,
        lr=0.12, seed=0)
    rows = torch.arange(n)
    idx = torch.randint(0, 32, (n, 3, 16), generator=torch.Generator().manual_seed(1))
    got = sc.sgd_stacked(params, sc.train_data("cpu"), rows, idx)
    layout = lenet_ref.Layout(model)
    pick = torch.arange(n)[:, None, None]
    ref = lenet_ref.sgd(layout, layout.flatten(params), inputs["train_images"][pick, idx],
                        inputs["train_labels"][pick, idx], 0.12)
    moved = ref - layout.flatten(params)
    assert float((layout.flatten(got) - ref).norm() / moved.norm()) < 1e-4
    acc = lenet.accuracy_stacked(params, inputs["eval_images"], inputs["eval_labels"])
    ref_acc = lenet_ref.accuracy(layout, layout.flatten(params), inputs["eval_images"],
                                 inputs["eval_labels"])
    assert torch.equal(acc, ref_acc)


def test_wire_is_bitwise_the_programs_roundtrip():
    from repro_torch.core import compression
    params = lenet_data.draw_params(CFG["model"], 5, 4, "cpu")
    params["f1"]["w"][0, :3] *= 1e-20          # tiny blocks
    params["c1"]["b"][1] = 0.0                  # an all-zero block
    layout = lenet_ref.Layout(CFG["model"])
    got = layout.flatten(compression.roundtrip_tree(params))
    ref = lenet_ref.roundtrip(layout, layout.flatten(params))
    assert torch.equal(got, ref)


@pytest.mark.parametrize("cell", ["lenet5-dfl.n1024", "lenet5-dfl.sweep24x10"])
def test_federation_cells_agree_with_the_reference_at_small_sizes(cell):
    nodes, ticks = (6, 24) if cell.endswith("n1024") else (10, 24)
    line, checks = harness.run_cell(cell, 2 ** 33 + 5, 0.0, 0, device="cpu",
                                    cell_override=_small.lenet_cell(cell, nodes, ticks))
    assert line["correct"], line["checks"]
    values = {k: v for k, v, _ in checks}
    assert values["events"] == 0 and values["wire_gap"] == 0
    assert values["follow_gap"] == 0 and values["rep_gap"] == 0


def test_schedule_counts_match_the_programs_run():
    from repro_torch.chain import scenarios, simlax
    from repro_torch.core.reputation import IMPL2
    sc, spec, topo, cfg = scenarios.lenet_paper_setup(12, ticks=30, train_steps=0)
    res = simlax.LaxSimulator(sc, topo, spec, IMPL2, cfg, device="cpu").run()
    cd = [3 + (5 * i) % 6 for i in range(12)]
    sched = fed_ref.Schedule(12, 2, 2, 1, 6, cd, 30, 12)
    assert fed_ref.count_mismatches(sched, res.stats) == 0


def test_glm_reference_matches_the_programs_step():
    from repro_torch.models import transformer
    from repro_torch.train import step as step_lib
    from perfbench.entries.lm_local_steps import arch_config
    config = _small.glm_config(json.loads(
        (harness.ROOT / "perfbench/configs/chatglm3-6b.json").read_text()))
    cfg = arch_config(config)
    meta = transformer.init(None, cfg, "meta")
    params = glm_weights.draw_params(meta, 9, "cpu")
    toks, labs = tokens.bigram_rows(9, cfg.vocab_size, 2, 64)
    batch = {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labs)}
    loss, _, grads = step_lib.loss_and_grads(params, cfg, batch)
    paths = [p for p, _ in glm_weights.leaf_paths(meta)]
    shapes = {p: tuple(t.shape) for p, t in glm_weights.leaf_paths(meta)}
    rcfg = {"num_layers": cfg.num_layers, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.num_kv_heads, "head_dim": cfg.resolved_head_dim,
            "d_model": cfg.d_model, "rope": cfg.rope, "rope_theta": cfg.rope_theta,
            "leaf_paths": paths}
    model = glm_ref.Model(rcfg, lambda p: glm_weights.draw_leaf(p, shapes[p], 9, "cpu"))
    ref_loss = glm_ref.Step(model).loss_backward(batch["tokens"], batch["labels"])
    assert abs(float(loss) - ref_loss) / ref_loss < 2e-3      # bf16 activations
    got = dict(glm_weights.leaf_paths(grads))
    for path, ts in model.leaves():
        ref = glm_ref.stacked([t.grad for t in ts])
        rel = float((got[path] - ref).norm() / ref.norm().clamp_min(1e-12))
        assert rel < 0.05, (path, rel)


def test_generators_are_seeded():
    a = lenet_data.draw_inputs(CFG["recipe"] | {"pool": 8, "eval_size": 4, "test_size": 8},
                               CFG["model"], 3, 2 ** 40 + 1, "cpu")
    b = lenet_data.draw_inputs(CFG["recipe"] | {"pool": 8, "eval_size": 4, "test_size": 8},
                               CFG["model"], 3, 2 ** 40 + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    t1, _ = tokens.bigram_rows(2 ** 40, 100, 3, 16)
    t2, _ = tokens.bigram_rows(2 ** 40, 100, 3, 16)
    assert np.array_equal(t1, t2)
