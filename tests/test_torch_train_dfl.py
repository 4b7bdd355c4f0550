"""The federated LM path of the port held against the JAX package's: one
DFL round (``gossip.make_local_steps`` of the train step, then
``make_gossip_round`` with the LM receipt) at F = 4 on CPU ranks
(``launch.mesh.spawn``, gloo) against the JAX round on 4 host devices in a
fresh interpreter, from the same JAX-initialised federation and the same
``TokenPipeline`` streams; and the launcher ``repro_torch.launch.train``
end to end, mirroring tests/test_train_cli.py: plain training with a
checkpoint chain and a resume, and ``--dfl --fed 4 --fail-node 1@2`` (the
ring renumbers 4 -> 3).

Tolerances: receipts within one token of the validation batch (bf16
logits: a near-tie in an argmax may go the other way), reputation rows
exactly, the loss within 5e-3 (bf16, tests/test_torch_train_step.py's
bound). Params: the first AdamW step moves each element by about +-lr
(1.5e-7), and an element whose grad is within bf16 noise of zero can move
the other way (measured: 13 of 16 384 embedding entries, 3.0e-7 apart);
so without compression within 2 lr plus 1e-6 of the leaf's largest
magnitude, and with int8 within one quantization step more (the largest
magnitude / 127: such a difference can carry an entry across a rounding
boundary). Reputation rows and the received-model counts exactly."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert, tree                            # noqa: E402
from repro_torch.configs import smoke_config                     # noqa: E402
from repro_torch.core import dfl as p_dfl                        # noqa: E402
from repro_torch.core import gossip                              # noqa: E402
from repro_torch.core.reputation import IMPL2                    # noqa: E402
from repro_torch.data.pipeline import TokenPipeline              # noqa: E402
from repro_torch.launch import mesh as mesh_lib                  # noqa: E402
from repro_torch.train import checkpoint as ckpt                 # noqa: E402
from repro_torch.train import step as p_step                     # noqa: E402

F, BATCH, SEQ, VAL_ROWS = 4, 2, 32, 2
COMPRESS = (None, "int8")
SPAWN_TIMEOUT = 180

JAX_ROUND = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.configs import smoke_config
from repro.core import dfl, gossip
from repro.core.reputation import IMPL2
from repro.data.pipeline import TokenPipeline
from repro.launch.mesh import make_fed_mesh
from repro.train import step

F, BATCH, SEQ, VAL_ROWS = 4, 2, 32, 2
cfg = smoke_config("llama3-8b")
mesh = make_fed_mesh(F, 1, 1)
fed_state, rep = dfl.init_federation(cfg, F, jax.random.PRNGKey(0))
out = {f"init/{i}": np.asarray(x) for i, x in enumerate(jax.tree.leaves(fed_state))}
pipe = TokenPipeline(cfg.vocab_size, BATCH, SEQ, fed_nodes=F)
local = jax.jit(gossip.make_local_steps(step.make_train_step(cfg), fed_axis="fed",
                                        mesh=mesh))
batches = {k: jnp.asarray(v) for k, v in pipe.fed_batches(0, 1).items()}
vb = {k: jnp.asarray(v[:, 0, :VAL_ROWS]) for k, v in pipe.fed_batches(10_000, 1).items()}
with mesh:
    fs, met = local(fed_state, batches)
out["loss"] = np.asarray(met["loss"])
for comp in (None, "int8"):
    gr = jax.jit(gossip.make_gossip_round(
        dfl.make_lm_eval_fn(cfg), fed_axis="fed", fed_size=F, ttl=1,
        rep_impl=IMPL2, compress=comp, mesh=mesh))
    with mesh:
        new, new_rep, gm = gr(fs["params"], rep, vb)
    for i, x in enumerate(jax.tree.leaves(new)):
        out[f"{comp}/params/{i}"] = np.asarray(x)
    out[f"{comp}/rep"] = np.asarray(new_rep)
    for k in ("mean_neighbor_acc", "min_neighbor_acc", "models_received"):
        out[f"{comp}/{k}"] = np.asarray(gm[k])
np.savez(sys.argv[1], **out)
print(json.dumps({"ok": True}))
"""


def _port_round(rank, dev, init):
    """One rank's node: the JAX federation's node ``rank`` carried across,
    one local step on its own stream, then the round with and without int8."""
    cfg = smoke_config("llama3-8b")
    like = p_step.init_train_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    leaves = [torch.from_numpy(np.ascontiguousarray(x[rank])) for x in init]
    state = tree.unflatten(like, leaves)
    pipe = TokenPipeline(cfg.vocab_size, BATCH, SEQ, fed_nodes=F)
    batches = {k: torch.as_tensor(v[rank]) for k, v in pipe.fed_batches(0, 1).items()}
    vb = {k: torch.as_tensor(v[rank, 0, :VAL_ROWS])
          for k, v in pipe.fed_batches(10_000, 1).items()}
    state, met = gossip.make_local_steps(p_step.make_train_step(cfg))(state, batches)
    out = {"loss": float(met["loss"])}
    for comp in COMPRESS:
        new, rep, gm = gossip.make_gossip_round(
            p_dfl.make_lm_eval_fn(cfg), fed_size=F, ttl=1, rep_impl=IMPL2,
            compress=comp)(state["params"], torch.ones(F), vb)
        out[comp] = (convert.params_to_numpy(new), rep.numpy(),
                     {k: float(v) for k, v in gm.items()})
    rows = [None] * F
    torch.distributed.all_gather_object(rows, out)
    return rows


def test_dfl_round_matches_jax_round(subprocess_runner, tmp_path):
    dst = tmp_path / "jax_round.npz"
    r = subprocess_runner(JAX_ROUND.replace("sys.argv[1]", repr(str(dst))),
                          host_devices=F)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(dst)
    n = len([k for k in want.files if k.startswith("init/")])
    init = [want[f"init/{i}"] for i in range(n)]
    ranks = mesh_lib.spawn(_port_round, F, device="cpu", timeout=SPAWN_TIMEOUT,
                           args=(init,))
    tokens = VAL_ROWS * SEQ
    lr0 = float(p_step.make_lr_fn(smoke_config("llama3-8b"))(0))
    for i, got in enumerate(ranks):
        assert abs(got["loss"] - float(want["loss"][i])) <= 5e-3
        for comp in COMPRESS:
            params, rep, gm = got[comp]
            np.testing.assert_array_equal(rep, want[f"{comp}/rep"][i])
            assert gm["models_received"] == float(want[f"{comp}/models_received"][i])
            for k in ("mean_neighbor_acc", "min_neighbor_acc"):
                assert abs(gm[k] - float(want[f"{comp}/{k}"][i])) <= 1 / tokens, k
            for j, leaf in enumerate(tree.leaves(params)):
                ref = want[f"{comp}/params/{j}"][i]
                scale = np.abs(ref).max()
                tol = 2 * lr0 + 1e-6 * scale + (0 if comp is None else scale / 127)
                np.testing.assert_allclose(leaf, ref, rtol=0, atol=tol,
                                           err_msg=f"{comp} leaf {j}")


def _lines(res, prefix):
    return [ln for ln in res.stdout.splitlines() if ln.startswith(prefix)]


PLAIN_RESUME = r"""
import json, tempfile
from repro_torch.launch import train as t
from repro_torch.train import checkpoint as ck
d = tempfile.mkdtemp()
t.main(["--arch", "llama3-8b", "--smoke", "--steps", "6", "--batch", "2",
        "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "3", "--device", "cpu"])
assert ck.verify_chain(d)
m = ck.latest_manifest(d)
assert m["step"] == 6, m["step"]
t.main(["--arch", "llama3-8b", "--smoke", "--steps", "8", "--batch", "2",
        "--seq", "32", "--ckpt-dir", d, "--resume", "--device", "cpu"])
print(json.dumps({"ok": True}))
"""

DFL_FAILURE = r"""
import json, tempfile
from repro_torch.launch import train as t
from repro_torch.train import checkpoint as ck
d = tempfile.mkdtemp()
out = t.main(["--arch", "llama3-8b", "--smoke", "--dfl", "--fed", "4",
              "--rounds", "4", "--local-steps", "1", "--ttl", "1", "--batch", "2",
              "--seq", "32", "--fail-node", "1@2", "--compress", "int8",
              "--ckpt-dir", d, "--ckpt-every", "2", "--device", "cpu",
              "--timeout", "240"])
m = ck.latest_manifest(d)
print(json.dumps({"ok": True, "extra": m["extra"],
                  "embed": m["arrays"]["params/embed/table"]["shape"],
                  "ranks": [r["rank"] for r in out],
                  "F": [[x["F"] for x in r["rounds"]] for r in out],
                  "quantize": [r["launches"].get("quantize", 0) for r in out]}))
"""


def test_launcher_plain_train_and_resume(subprocess_runner):
    res = subprocess_runner(PLAIN_RESUME)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["ok"]
    assert "[train] resumed from step 6 (chain ok: True)" in res.stdout
    steps = _lines(res, "[train] step ")
    assert [s.split()[2] for s in steps] == ["0", "5", "7"]
    assert all(np.isfinite(float(s.split()[4])) for s in steps)
    assert _lines(res, "[train] checkpoint chain ok:") == [
        "[train] checkpoint chain ok: True"] * 2


def test_launcher_dfl_federation_with_failure(subprocess_runner):
    res = subprocess_runner(DFL_FAILURE)
    assert res.returncode == 0, res.stderr[-2000:]
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["extra"] == {"mode": "dfl", "fed": 3}
    assert last["embed"] == [3, 256, 64]       # the survivors' states, stacked
    assert last["ranks"] == [0, 2, 3] and last["F"] == [[4, 4, 3, 3]] * 3
    assert last["quantize"] == [0, 0, 0]       # CPU tensors: plain version
    assert "[dfl] replica 1 FAILED at round 2; ring renumbers 4 -> 3" in res.stdout
    rounds = _lines(res, "[dfl] round ")
    assert [r.split()[2:4] for r in rounds] == [["0", "F=4"], ["1", "F=4"],
                                                ["2", "F=3"], ["3", "F=3"]]
    for r in rounds:
        fields = dict(x.split("=") for x in r.split()[4:])
        assert np.isfinite(float(fields["loss"]))
        assert 0.0 <= float(fields["neighbor_acc"]) <= 1.0
        assert 0.0 <= float(fields["rep_min"]) <= 1.0
    assert "[train] checkpoint chain ok: True" in res.stdout


def test_launcher_defaults_to_the_card_and_names_unported_archs(monkeypatch):
    from repro_torch.launch import train as t
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        t.main(["--arch", "llama3-8b", "--smoke", "--steps", "1"])
    with pytest.raises(NotImplementedError, match="LM zoo"):
        t.main(["--smoke", "--device", "cpu"])       # default arch xlstm-125m
    args = t.parse_args([])
    assert (args.arch, args.device, args.backend, args.compress) == (
        "xlstm-125m", "cuda", None, None)
    assert ckpt.SHARD == "shard-0.npz"
