"""The MoE training cell and the heap-chain cell at tiny sizes on the CPU:
each runs through the harness and reads correct where it should; the
planted faults move the check's numbers; a program without the MoE
fields stops at set-up."""
import copy

import pytest
import torch

from perfbench import harness, moe_readings

SEED = 2 ** 33 + 7


def _moe_cell(cell):
    cell = copy.deepcopy(cell)
    cell["traffic"].update(batch=2, seq=64, pool_rows=40)
    return cell


def _moe_config(config):
    config = copy.deepcopy(config)
    config["arch"].update(num_layers=7, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256, window=8)
    config["arch"]["moe"].update(num_experts=16, top_k=4, d_ff_expert=32,
                                 held=[0, 8], first_dense=1)
    return config


def _moe_run():
    _, _, cell, config = harness.cell_files(harness.ROOT, "trinity-mini.local-steps")
    mod = harness.load_module(harness.ROOT / "perfbench/entries/moe_local_steps.py",
                              "perfbench_entry_moe_local_steps")
    bench = harness.Bench("trinity-mini.local-steps", _moe_cell(cell), _moe_config(config),
                          SEED, torch.device("cpu"), 1)
    return mod, mod.setup(bench)


def test_moe_cell_runs_and_faults_move_its_numbers():
    """At d 64 the bf16 gaps are far above the card's limits, so the test
    holds the order: every planted fault reads worse than the sound run
    on the number that catches it at the cell's size."""
    mod, run = _moe_run()
    progs = {"sound": (run.prog, run.tap.steps)}
    assert run.dropped == 0
    for name, plant in moe_readings.FAULTS.items():
        undo = plant(run)
        try:
            run.rerun()
        finally:
            undo()
        progs[name] = (run.prog, run.tap.steps)
    gaps = {}
    for name, (prog, steps) in progs.items():
        run.tap.steps = steps
        gaps[name] = mod.gaps(prog, run.reference(), run.cfg.moe.bias_rate)
    sound = gaps["sound"]
    assert sound["bias_gap"] == 0
    assert gaps["bias_left_out"]["bias_gap"] >= 1
    assert run.dropped > 0             # the shifted range computes other pairs
    for name in ("expert_fp8", "held_shifted", "gate_left_out"):
        assert gaps[name]["grad_gap"] > sound["grad_gap"], name
        assert gaps[name]["route_off"] > sound["route_off"], name


def test_moe_cell_stops_on_a_program_without_the_fields():
    """A key the program's configs lack (as the parent lacks the MoE ones)
    stops set-up with SystemExit, the harness's clean refusal."""
    _, _, _, config = harness.cell_files(harness.ROOT, "trinity-mini.local-steps")
    mod = harness.load_module(harness.ROOT / "perfbench/entries/moe_local_steps.py",
                              "perfbench_entry_moe_local_steps")
    for group in ("arch", "moe"):
        bad = copy.deepcopy(config)
        (bad["arch"] if group == "arch" else bad["arch"]["moe"])["a_new_field"] = 1
        with pytest.raises(SystemExit, match="a_new_field"):
            mod.arch_config(bad)


def _heap_cell(cell):
    cell = copy.deepcopy(cell)
    cell["traffic"]["ticks"] = 36
    return cell


def test_heap_cell_is_correct_and_reads_a_forged_receipt():
    line, checks = harness.run_cell("lenet5-dfl.heap-n10", SEED, 0.0, 0, device="cpu",
                                    cell_override=_heap_cell)
    assert line["correct"], line["checks"]
    mod = harness.load_module(harness.ROOT / "perfbench/entries/heap_federation.py",
                              "perfbench_entry_heap_federation")
    _, _, cell, config = harness.cell_files(harness.ROOT, "lenet5-dfl.heap-n10")
    run = mod.setup(harness.Bench("lenet5-dfl.heap-n10", _heap_cell(cell), config, SEED,
                                  torch.device("cpu"), 1))
    run.unit()
    nodes = run.first[0]
    blocks = [b for nd in nodes for b in nd.ledger.blocks[1:]]
    receipt = blocks[0].transactions[0].receipts[0]
    receipt.accuracy = 1.0 - receipt.accuracy            # an altered receipt
    values = {k: v for k, v, _ in run.check()}
    run.release()
    assert values["chain_off"] >= 1
