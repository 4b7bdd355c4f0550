"""The harness: cells, configurations and metrics found by name, the result
line's keys, the refusal without a card."""
import json
import shutil

import torch

from perfbench import harness
from perfbench.tests import _small

torch.set_num_threads(4)


def test_cell_config_and_metric_added_as_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.ROOT / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pb = root / "perfbench"
    config = json.loads((pb / "configs" / "lenet5-dfl.json").read_text())
    config["name"] = "lenet5-dfl-short"
    config["recipe"]["ticks"] = 24
    (pb / "configs" / "lenet5-dfl-short.json").write_text(json.dumps(config))
    cell = json.loads((pb / "workloads" / "lenet5-dfl.n1024.json").read_text())
    cell.update(name="lenet5-dfl-short.n8", config="lenet5-dfl-short")
    cell["traffic"]["nodes"] = 8
    (pb / "workloads" / "lenet5-dfl-short.n8.json").write_text(json.dumps(cell))
    (pb / "metrics" / "federations_per_s.py").write_text(
        "def read(ctx):\n    return ctx.counts['federations'] / ctx.window_s\n")
    manifest["configs"].append({"name": "lenet5-dfl-short", "source": "x", "reduced": [],
                                "file": "perfbench/configs/lenet5-dfl-short.json",
                                "why": "a test"})
    manifest["workloads"].append({"name": "lenet5-dfl-short.n8", "config": "lenet5-dfl-short",
                                  "traffic": "n8", "chips": 1, "why": "a test"})
    manifest["end_to_end"].append({"name": "federations_per_s", "unit": "1/s",
                                   "better": "higher", "bound": 0.05, "source": "host_clock",
                                   "workloads": ["lenet5-dfl-short.n8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    line, checks = harness.run_cell("lenet5-dfl-short.n8", 7, 0.0, 0, device="cpu",
                                    root=root)
    assert line["correct"], line["checks"]
    assert "federations_per_s" in line["metrics"]
    assert "setup_s" in line["metrics"] and "fed_ticks_per_s" not in line["metrics"]
    assert line["attempted"] == 1


def test_result_line_keys_and_checks_last():
    line, checks = harness.run_cell("lenet5-dfl.n1024", 2 ** 31 + 12345, 0.0, 0,
                                    device="cpu", cell_override=_small.lenet_cell(
                                        "lenet5-dfl.n1024"))
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert {m for m in line["metrics"]} >= {"fed_ticks_per_s", "setup_s"}
    assert [c for c, _, _ in checks] == list(line["checks"])
    for v in line["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(line)


def test_without_a_card_the_run_exits_nonzero_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        return
    rc = harness.main(["--workload", "lenet5-dfl.n1024", "--seed", "1", "--seconds", "1"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_every_manifest_name_has_its_files():
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    pb = harness.ROOT / "perfbench"
    for c in manifest["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
    for w in manifest["workloads"]:
        cell = json.loads((pb / "workloads" / f"{w['name']}.json").read_text())
        assert cell["config"] == w["config"] and cell["why"] == w["why"]
        assert (pb / "entries" / f"{cell['entry']}.py").is_file()
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert (pb / "metrics" / f"{m['name']}.py").is_file()
