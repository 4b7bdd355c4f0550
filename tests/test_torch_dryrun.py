"""The port's dry-run command line (``repro_torch.launch.dryrun``) held
against the JAX package's (``repro.launch.dryrun``) on the CPU.

The JAX command line runs in one fresh interpreter for the whole file
(conftest's ``subprocess_runner``): importing ``repro.launch.dryrun`` sets
``XLA_FLAGS`` to 512 host devices, which in this process would change the
device count of every later test on the worker. That interpreter reads the
JAX parser's options and runs each JAX command line below once; the port
runs in process with ``--device cpu``, except the sharded run, which goes
through ``python -m repro_torch.launch.dryrun`` (its ranks are spawned).

Bounds: the event and byte counters of a LeNet federation with a fixed
train interval are exact; honest accuracy and the poisoners' reputation
within 0.05 (the two packages draw their train batches from different
generators; measured here 1.3e-3 and 5.6e-3). The toy scenario draws its
train intervals, so only its record's keys and types are compared."""
import argparse
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch.launch import dryrun                      # noqa: E402
from repro_torch.configs import PORT_ONLY_IDS                # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")
LAX = ["--engine", "lax", "--scenario", "lenet", "--attack", "signflip",
       "--nodes", "10", "--ticks", "12", "--topology", "kregular", "--ttl", "2",
       "--compress", "int8"]
TOY = ["--engine", "lax", "--nodes", "16", "--ticks", "24"]
SWEEP = ["--sweep", "--sweep-sizes", "8", "--sweep-attacks", "none,signflip",
         "--sweep-seeds", "0", "--ticks", "16"]
# node 7 is online at tick 10, so both command lines reject this schedule
# when the run validates it
CHURN = ["--churn", "10:leave:3+5", "--churn", "10:join:7", "--churn-offline", "2"]
CHURN_EVENTS = [(10, (7,), (3, 5))]
# a schedule the run accepts: node 2 offline from tick 0 joins (no rejoin),
# 3 and 5 leave at tick 10, 3 rejoins at 16
CHURN_OK = ["--churn", "10:leave:3+5", "--churn", "10:join:2", "--churn",
            "16:join:3", "--churn-offline", "2"]
CHURN_OK_EVENTS = [(10, (2,), (3, 5)), (16, (3,), ())]
COUNTERS = ("broadcasts", "deliveries", "fedavg_rounds", "wire_bytes",
            "broadcast_bytes", "delivery_budget", "compact_budget",
            "max_tick_deliveries")
ACC_TOL = 0.05
JAX_RUNS = {"lax": LAX, "toy": TOY, "sweep": SWEEP,
            "churn": TOY + CHURN, "churn_ok": TOY + CHURN_OK}

_JAX_CODE = """
import argparse, json, os, sys
from repro.launch import dryrun
out_dir, runs, churn = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
res = {}
orig = argparse.ArgumentParser.parse_args

def capture(self, args=None, namespace=None):
    res["help"] = self.format_help()
    res["actions"] = [[a.option_strings, a.default,
                       None if a.choices is None else list(a.choices)]
                      for a in self._actions]
    raise SystemExit(0)

argparse.ArgumentParser.parse_args = capture
sys.argv = ["dryrun"]
try:
    dryrun.main()
except SystemExit:
    pass
argparse.ArgumentParser.parse_args = orig
for name, argv in runs.items():
    out = os.path.join(out_dir, name + ".json")
    sys.argv = ["dryrun", *argv, "--out", out]
    try:
        dryrun.main()
        with open(out) as f:
            res[name] = json.load(f)[-1]
    except Exception as e:
        res[name] = {"error": f"{type(e).__name__}: {e}"}
ns = argparse.Namespace(churn=churn, churn_offline="2", churn_decay=0.5)
sched = dryrun._parse_churn(ns)
res["churn_schedule"] = {
    "events": [[e.tick, list(e.joins), list(e.leaves)] for e in sched.events],
    "initial_offline": list(sched.initial_offline),
    "rejoin_decay": sched.rejoin_decay}
print("RESULT " + json.dumps(res))
"""

_JAX = {}


def _jax(subprocess_runner, tmp_path_factory):
    """The JAX command line's parser and records, run once for the file."""
    if not _JAX:
        out_dir = tmp_path_factory.mktemp("jax_dryrun")
        churn = [v for k, v in zip(CHURN[::2], CHURN[1::2]) if k == "--churn"]
        proc = subprocess_runner(
            f"import sys\nsys.argv = ['-c', {str(out_dir)!r}, "
            f"{json.dumps(JAX_RUNS)!r}, {json.dumps(churn)!r}]\n" + _JAX_CODE)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
        assert proc.returncode == 0 and lines, proc.stderr[-4000:]
        _JAX.update(json.loads(lines[-1][len("RESULT "):]))
    return _JAX


def _port(tmp_path, argv, name="port"):
    out = str(tmp_path / f"{name}.json")
    assert dryrun.main([*argv, "--out", out, "--device", "cpu"]) == 0
    with open(out) as f:
        return json.load(f)[-1]


def _actions(parser_actions):
    return {tuple(opts): (default, choices)
            for opts, default, choices in parser_actions if opts}


def test_parser_has_every_jax_option_with_its_default(subprocess_runner,
                                                      tmp_path_factory):
    j = _jax(subprocess_runner, tmp_path_factory)
    want = _actions(j["actions"])
    got = _actions([[a.option_strings, a.default,
                     None if a.choices is None else list(a.choices)]
                    for a in dryrun.build_parser()._actions])
    assert all(opt in j["help"] for opts in want for opt in opts)
    assert set(want) <= set(got), set(want) - set(got)
    for opts, (default, choices) in want.items():
        if opts == ("--arch",):       # the port's own archs after the JAX zoo's
            choices = choices + list(PORT_ONLY_IDS)
        assert got[opts] == (default, choices), (opts, got[opts], default, choices)
    assert set(got) - set(want) == {("--device",)}
    assert got[("--device",)][0] == "cuda"


def test_lax_lenet_matches_jax(subprocess_runner, tmp_path_factory, tmp_path):
    j = _jax(subprocess_runner, tmp_path_factory)["lax"]
    p = _port(tmp_path, LAX)
    assert set(j) <= set(p), set(j) - set(p)
    assert {k: p[k] for k in COUNTERS} == {k: j[k] for k in COUNTERS}
    for k in ("engine", "scenario", "model", "status", "attack", "attack_params",
              "delivery", "topology", "shards", "churn_events", "ttl", "nodes",
              "ticks", "compress"):
        assert p[k] == j[k], k
    assert abs(p["honest_acc"] - j["honest_acc"]) <= ACC_TOL
    assert abs(p["malicious_reputation"] - j["malicious_reputation"]) <= ACC_TOL
    assert p["device"] == "cpu"


def test_toy_record_keys_and_types(subprocess_runner, tmp_path_factory, tmp_path):
    j = _jax(subprocess_runner, tmp_path_factory)["toy"]
    p = _port(tmp_path, TOY)
    assert set(j) <= set(p)
    assert {k: type(p[k]).__name__ for k in j} == {k: type(v).__name__
                                                   for k, v in j.items()}
    assert (p["scenario"], p["nodes"], p["ticks"], p["attack"]) == ("toy", 16, 24,
                                                                    "gaussian")
    # the record goes to the --out list after the ones already there
    p2 = _port(tmp_path, TOY)
    with open(tmp_path / "port.json") as f:
        assert len(json.load(f)) == 2
    assert {k: p2[k] for k in COUNTERS} == {k: p[k] for k in COUNTERS}


def test_sharded_over_two_spawned_ranks_gives_compact_counters(
        subprocess_runner, tmp_path_factory, tmp_path):
    """--delivery sharded --mesh 2 through ``python -m`` on the CPU: two
    gloo ranks, rank 0 writes the record."""
    j = _jax(subprocess_runner, tmp_path_factory)["lax"]
    out = tmp_path / "sharded.json"
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *LAX, "--delivery",
         "sharded", "--mesh", "2", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[dryrun] lax lenet attack=signflip n=10" in proc.stdout
    with open(out) as f:
        (p,) = json.load(f)
    assert (p["delivery"], p["shards"]) == ("sharded", 2)
    assert {k: p[k] for k in COUNTERS} == {k: j[k] for k in COUNTERS}
    assert abs(p["honest_acc"] - j["honest_acc"]) <= ACC_TOL


def _churn_events(sched):
    return [(e.tick, tuple(e.joins), tuple(e.leaves)) for e in sched.events]


def test_churn_schedule_matches_jax(subprocess_runner, tmp_path_factory, tmp_path):
    j = _jax(subprocess_runner, tmp_path_factory)
    args = dryrun.build_parser().parse_args(CHURN)
    sched = dryrun._parse_churn(args)
    assert _churn_events(sched) == CHURN_EVENTS
    assert (sched.initial_offline, sched.rejoin_decay) == ((2,), 0.5)
    assert j["churn_schedule"] == {
        "events": [[t, list(jn), list(lv)] for t, jn, lv in CHURN_EVENTS],
        "initial_offline": [2], "rejoin_decay": 0.5}
    # the run rejects it in both packages, with the same message
    with pytest.raises(ValueError) as err:
        _port(tmp_path, TOY + CHURN)
    assert j["churn"]["error"] == f"ValueError: {err.value}"
    assert "node 7 joins at tick 10 but is already online" in str(err.value)
    # a schedule the run accepts: two events in the record of both
    assert _churn_events(dryrun._parse_churn(
        dryrun.build_parser().parse_args(CHURN_OK))) == CHURN_OK_EVENTS
    p = _port(tmp_path, TOY + CHURN_OK, "churn_ok")
    assert p["churn_events"] == j["churn_ok"]["churn_events"] == 2


def test_sweep_matches_jax(subprocess_runner, tmp_path_factory, tmp_path):
    j = _jax(subprocess_runner, tmp_path_factory)["sweep"]
    p = _port(tmp_path, SWEEP)
    assert set(j) <= set(p), set(j) - set(p)
    for k in ("engine", "status", "scenario", "topology", "ttl", "ticks",
              "delivery", "sizes", "attacks", "cells", "batches"):
        assert p[k] == j[k], k
    assert p["devices"] == 1 and p["device"] == "cpu"
    for table in ("time_to_accuracy", "accuracy_under_attack"):
        rows = lambda r: [(x["attack"], x["size"]) for x in r["frontier"][table]]
        assert rows(p) == rows(j)
    assert [(o["attack"], o["size"], o["seed"]) for o in p["outcomes"]] == [
        (o["attack"], o["size"], o["seed"]) for o in j["outcomes"]]


@pytest.mark.parametrize("argv,match", [
    (TOY + ["--attack-arg", "x"], "--attack-arg expects k=v"),
    (TOY + ["--churn", "10:stay:3"], "--churn expects TICK:join"),
    (TOY + ["--churn", "x:join:3"], "--churn expects integer"),
    (TOY + ["--mesh", "2"], "--mesh only applies to --delivery sharded"),
    (LAX + ["--delivery", "sharded", "--mesh", "3"], "divisible"),
])
def test_bad_arguments_exit(argv, match, tmp_path):
    with pytest.raises(SystemExit, match=match):
        _port(tmp_path, argv)


@pytest.mark.parametrize("argv", [
    ["--engine", "mesh", "--arch", "llama3-8b", "--shape", "train_4k"],
    ["--arch", "llama3-8b", "--shape", "train_4k", "--dfl", "--topology",
     "smallworld", "--ttl", "2", "--compress", "int8"],
    [],
])
def test_cell_report_runs_on_the_meta_device(argv, tmp_path, capsys):
    """The cell report's argvs (the JAX default route): a mesh record, a
    gossip round's record with its permute bytes, and without a cell the
    JAX command line's usage error. ``tests/test_torch_cellreport.py``
    holds the records to JAX's."""
    out = tmp_path / "cells.json"
    if not argv:
        with pytest.raises(SystemExit) as err:
            dryrun.main([*argv, "--out", str(out)])
        assert err.value.code == 2 and not out.exists()
        assert "--arch/--shape or --all required" in capsys.readouterr().err
        return
    assert dryrun.main([*argv, "--out", str(out)]) == 0
    with open(out) as f:
        (rec,) = json.load(f)
    assert (rec["status"], rec["device"], rec["arch"]) == ("ok", "meta", "llama3-8b")
    assert None not in rec["bytes_per_device"].values()
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    if "--dfl" in argv:
        assert rec["step_kind"] == "gossip" and rec["permute_bytes"] > 0
        assert rec["topology"] == "smallworld" and rec["compress"] == "int8"
    else:
        assert rec["step_kind"] == "train" and rec["permute_bytes"] is None


@pytest.mark.parametrize("argv", [TOY, SWEEP])
def test_default_device_raises_without_cuda(argv, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main([*argv, "--out", str(tmp_path / "x.json")])
    assert not (tmp_path / "x.json").exists()


def test_parse_helpers_match_the_jax_rules():
    assert dryrun._parse_attack_args(["a=1", "b=2.5", "c=x", "d=1=2"]) == {
        "a": 1, "b": 2.5, "c": "x", "d": "1=2"}
    ns = argparse.Namespace(churn=[], churn_offline="", churn_decay=0.5)
    assert dryrun._parse_churn(ns) is None
