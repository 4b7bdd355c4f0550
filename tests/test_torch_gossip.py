"""The port's production gossip round (``repro_torch.core.gossip``) on gloo
ranks, the counterpart of tests/test_gossip.py.

Each rank runs the round for its own node; ranks start through
``repro_torch.launch.mesh.spawn`` (``FileStore`` rendezvous, a timeout that
kills every rank). Each multi-rank case batches its checks into one spawn
(4 ranks, 8 ranks), run once a module and shared by the tests that read it.
The parity case runs the JAX round in a fresh interpreter with 4 host
devices on the same numpy inputs.
"""
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)

from repro_torch.core import compression, gossip                   # noqa: E402
from repro_torch.core import topology as T                         # noqa: E402
from repro_torch.core.reputation import IMPL1, IMPL2               # noqa: E402
from repro_torch.launch import mesh as mesh_lib                    # noqa: E402

F4, D4 = 4, 8          # the oracle case (tests/test_gossip.py GOSSIP_EQUIV)
F8, D8 = 8, 16         # the topology case (TOPOLOGY_GOSSIP)
SPAWN_TIMEOUT = 120


def _gather(obj):
    out = [None] * torch.distributed.get_world_size()
    torch.distributed.all_gather_object(out, obj)
    return out


def _numpy(metrics):
    return {k: float(v) for k, v in metrics.items()}


def _deg1_topology(f):
    """tests/test_gossip.py's degree-1 scenario: a triangle, a path and a
    closing edge, with one node forced to degree 1."""
    adj = np.zeros((f, f), bool)
    for a, b in [(0, 1), (1, 2), (2, 0), (2, 3)] + [
            (i, (i + 1) % 4) for i in range(4, f - 1)]:
        adj[a, b] = adj[b, a] = True
    adj[3, 4] = adj[4, 3] = True
    adj[f - 1, 0] = adj[0, f - 1] = True
    if not (adj.sum(1) == 1).any():
        adj[5, 6] = adj[6, 5] = False
    return T.Topology("custom", adj)


TOPOLOGIES = {
    "ring": lambda f: T.ring(f),
    "kregular": lambda f: T.kregular(f, 2),
    "erdos": lambda f: T.erdos_renyi(f, 0.4, 1),
    "smallworld": lambda f: T.small_world(f, 2, 0.3, 0),
    "full": lambda f: T.full(f),
}


def _parity_inputs():
    """The parity case's numpy inputs: per-node params {w (512,), b (2, 3)}
    with well separated means, reputation rows in [0.5, 1], and one eval
    scale a node."""
    rng = np.random.RandomState(0)
    w = (rng.normal(0, 0.1, (F4, 512)) + 0.05 * np.arange(F4)[:, None])
    return {"w": w.astype(np.float32),
            "b": rng.normal(0, 0.1, (F4, 2, 3)).astype(np.float32),
            "rep": rng.uniform(0.5, 1.0, (F4, F4)).astype(np.float32),
            "vb": rng.uniform(0.5, 1.5, (F4, 1)).astype(np.float32)}


def _parity_eval(p, v):
    return torch.clamp(torch.mean(p["w"]) * v[0] + 0.5, 0.0, 1.0)


def _ranks4(rank, dev):
    mesh = mesh_lib.make_fed_mesh(F4)
    out = {}
    # the round against the host oracle: ring, ttl 1
    models = torch.arange(F4 * D4, dtype=torch.float32).reshape(F4, D4)
    round_ = gossip.make_gossip_round(
        lambda p, vb: torch.clamp(torch.mean(p) / 40.0, 0.0, 1.0),
        fed_size=F4, ttl=1, rep_impl=IMPL2, mesh=mesh)
    new, rep, met = round_(models[rank], torch.ones(F4), torch.zeros(1))
    out["oracle"] = (new.numpy(), rep.numpy(), _numpy(met))

    # local steps: 'training' adds the batch mean; a leak would show
    def train_step(state, batch):
        return {"w": state["w"] + torch.mean(batch)}, {"loss": torch.mean(batch)}

    batches = torch.arange(F4 * 3 * 2, dtype=torch.float32).reshape(F4, 3, 2)
    state, met = gossip.make_local_steps(train_step)(
        {"w": torch.zeros(2)}, batches[rank])
    out["local"] = (state["w"].numpy(), float(met["loss"]))

    # int8 against exact, and the bytes each sends
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn((F4, 512), generator=g)[rank],
            "b": torch.randn((F4, 2, 260), generator=g)[rank]}
    for comp in (None, "int8"):
        gossip.reset_wire()
        new, _, met = gossip.make_gossip_round(
            lambda p, vb: torch.tensor(0.5), fed_size=F4, ttl=1,
            rep_impl=IMPL1, compress=comp, mesh=mesh)(tree, torch.ones(F4),
                                                      torch.zeros(1))
        out[f"wire_{comp}"] = ({k: v.numpy() for k, v in new.items()},
                               dict(gossip.WIRE), _numpy(met))

    # tree_ppermute: mixed dtypes bit for bit, zeros where nothing arrives
    leaves = {"f": torch.full((3,), rank + 0.25), "i8": torch.full((5,), rank - 2,
                                                                    dtype=torch.int8),
              "bf": torch.full((2, 2), rank + 0.5, dtype=torch.bfloat16),
              "l": torch.full((), 10 ** 12 + rank, dtype=torch.int64)}
    got = gossip.tree_ppermute(leaves, mesh_lib.fed_group(mesh), [(0, 1), (2, 0)])
    out["ppermute"] = {k: v.float().numpy() if v.dtype == torch.bfloat16
                       else v.numpy() for k, v in got.items()}

    # the parity case's port side
    x = _parity_inputs()
    params = {"w": torch.as_tensor(x["w"][rank]), "b": torch.as_tensor(x["b"][rank])}
    for comp in (None, "int8"):
        new, rep, met = gossip.make_gossip_round(
            _parity_eval, fed_size=F4, ttl=2, rep_impl=IMPL2, compress=comp,
            mesh=mesh, topology=T.ring(F4))(
                params, torch.as_tensor(x["rep"][rank]),
                torch.as_tensor(x["vb"][rank]))
        out[f"parity_{comp}"] = ({k: v.numpy() for k, v in new.items()},
                                 rep.numpy(), _numpy(met))
    return _gather(out)


def _ranks8(rank, dev):
    mesh = mesh_lib.make_fed_mesh(F8)
    group = mesh_lib.fed_group(mesh)
    models = torch.arange(F8 * D8, dtype=torch.float32).reshape(F8, D8) / (F8 * D8)

    def run(topo, ttl, schedule="frontier"):
        gossip.reset_wire()
        new, rep, met = gossip.make_gossip_round(
            lambda p, vb: torch.clamp(torch.mean(p) + 0.5, 0.0, 1.0),
            fed_size=F8, ttl=ttl, rep_impl=IMPL2, mesh=mesh, topology=topo,
            schedule=schedule)(models[rank], torch.ones(F8), torch.zeros(1))
        return new.numpy(), rep.numpy(), _numpy(met), gossip.WIRE["messages"]

    out = {}
    for kind, make in TOPOLOGIES.items():
        for ttl in (1, 2):
            out[kind, ttl] = run(make(F8), ttl)
    for kind in ("erdos", "smallworld"):
        out[kind, 2, "chain"] = run(TOPOLOGIES[kind](F8), 2, "chain")
    out["deg1"] = run(_deg1_topology(F8), 1)
    assert torch.distributed.get_world_size(group) == F8
    return _gather(out)


_SPAWNED = {}


def _spawned(world):
    if world not in _SPAWNED:
        fn = {F4: _ranks4, F8: _ranks8}[world]
        _SPAWNED[world] = mesh_lib.spawn(fn, world, device="cpu",
                                         timeout=SPAWN_TIMEOUT)
    return _SPAWNED[world]


def _ball_oracle(models, topo, ttl, acc_of, rep=None):
    """Each node's Eq. 3 over its ttl-ball, weighted rep * receipt."""
    f = models.shape[0]
    dist = topo.hop_distance()
    expect = np.zeros_like(models, dtype=np.float64)
    for i in range(f):
        ball = [j for j in range(f) if 1 <= dist[i, j] <= ttl]
        w = np.array([(1.0 if rep is None else rep[i, j]) * acc_of(i, j)
                      for j in ball])
        expect[i] = 0.5 * ((w / w.sum()) @ models[ball] + models[i])
    return expect, dist


# ---------------------------------------------------------------- 4 ranks
def test_gossip_matches_oracle():
    res = _spawned(F4)
    models = np.arange(F4 * D4, dtype=np.float32).reshape(F4, D4)

    def acc_of(i, j):
        return float(np.clip(models[j].mean() / 40.0, 0, 1))

    expect, _ = _ball_oracle(models, T.ring(F4), 1, acc_of)
    got = np.stack([r["oracle"][0] for r in res])
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    # reputation: each node punished its lowest-accuracy neighbour by 0.05
    for i in range(F4):
        worst = min([(i - 1) % F4, (i + 1) % F4], key=lambda j: acc_of(i, j))
        rep = res[i]["oracle"][1]
        assert abs(rep[worst] - 0.95) < 1e-6, (i, rep)
        assert res[i]["oracle"][2]["models_received"] == 2.0


def test_local_steps_isolated_per_node():
    res = _spawned(F4)
    batches = np.arange(F4 * 3 * 2, dtype=np.float32).reshape(F4, 3, 2)
    for i in range(F4):
        w, loss = res[i]["local"]
        np.testing.assert_allclose(w[0], batches[i].mean(1).sum(), rtol=1e-6)
        assert loss == pytest.approx(batches[i][-1].mean())


def test_int8_gossip_close_to_exact_and_sends_int8_bytes():
    res = _spawned(F4)
    exact = np.stack([r["wire_None"][0]["w"] for r in res])
    quant = np.stack([r["wire_int8"][0]["w"] for r in res])
    rel = np.abs(exact - quant).max() / np.abs(exact).max()
    assert rel < 0.02, rel
    like = {"w": torch.empty(512), "b": torch.empty(2, 260)}
    steps = T.gossip_schedule(T.ring(F4), 1).num_collectives
    for r in res:
        assert r["wire_None"][1]["bytes"] == steps * compression.payload_bytes(like, None)
        assert r["wire_int8"][1]["bytes"] == steps * compression.payload_bytes(like, "int8")
        assert r["wire_int8"][1]["messages"] == steps


def test_tree_ppermute_moves_bits_and_zeros_the_rest():
    res = _spawned(F4)
    for rank, sender in ((1, 0), (0, 2)):
        got = res[rank]["ppermute"]
        np.testing.assert_array_equal(got["f"], np.full(3, sender + 0.25, np.float32))
        np.testing.assert_array_equal(got["i8"], np.full(5, sender - 2, np.int8))
        np.testing.assert_array_equal(got["bf"], np.full((2, 2), sender + 0.5))
        assert int(got["l"]) == 10 ** 12 + sender
    for rank in (2, 3):
        for v in res[rank]["ppermute"].values():
            assert not np.any(v)


JAX_ROUND = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from repro.core import gossip, topology as T
from repro.core.reputation import IMPL2
from repro.launch.mesh import make_fed_mesh

x = np.load(sys.argv[1])
F = 4
mesh = make_fed_mesh(F, 1, 1)
params = {"w": jnp.asarray(x["w"]), "b": jnp.asarray(x["b"])}
def eval_fn(p, v):
    return jnp.clip(jnp.mean(p["w"]) * v[0] + 0.5, 0.0, 1.0)
out = {}
for comp in (None, "int8"):
    fn = gossip.make_gossip_round(
        eval_fn, fed_axis="fed", fed_size=F, ttl=2, rep_impl=IMPL2,
        compress=comp, mesh=mesh, topology=T.ring(F))
    with mesh:
        new, rep, m = jax.jit(fn)(params, jnp.asarray(x["rep"]),
                                  jnp.asarray(x["vb"]))
    for k in ("w", "b"):
        out[f"{comp}_{k}"] = np.asarray(new[k])
    out[f"{comp}_rep"] = np.asarray(rep)
    out[f"{comp}_received"] = np.asarray(m["models_received"])
np.savez(sys.argv[2], **out)
print(json.dumps({"ok": True}))
"""


@pytest.mark.parametrize("compress", [None, "int8"])
def test_round_matches_jax_round(subprocess_runner, tmp_path, compress):
    """The same numpy inputs through repro.core.gossip (4 host devices) and
    through the port's ranks: params within rtol 1e-6 (atol one ulp at the
    params' largest magnitude), reputation rows exactly."""
    src, dst = tmp_path / "in.npz", tmp_path / "out.npz"
    np.savez(src, **_parity_inputs())
    code = JAX_ROUND.replace("sys.argv[1]", repr(str(src))).replace(
        "sys.argv[2]", repr(str(dst)))
    r = subprocess_runner(code, host_devices=4)
    assert r.returncode == 0, r.stderr[-3000:]
    want = np.load(dst)
    res = _spawned(F4)
    for i, rank in enumerate(res):
        params, rep, met = rank[f"parity_{compress}"]
        for k in ("w", "b"):
            # XLA contracts the streaming sum's multiply-adds: entries that
            # cancel to near zero keep an absolute error of an ulp or two of
            # the addends, so atol is one ulp at the largest magnitude
            ref = want[f"{compress}_{k}"][i]
            np.testing.assert_allclose(
                params[k], ref, rtol=1e-6,
                atol=np.spacing(np.abs(ref).max()), err_msg=k)
        np.testing.assert_array_equal(rep, want[f"{compress}_rep"][i])
        assert met["models_received"] == want[f"{compress}_received"][i] == 3.0


# ---------------------------------------------------------------- 8 ranks
@pytest.mark.parametrize("ttl", [1, 2])
@pytest.mark.parametrize("kind", list(TOPOLOGIES))
def test_topology_kinds_match_ball_oracle(kind, ttl):
    res = _spawned(F8)
    models = np.arange(F8 * D8, dtype=np.float32).reshape(F8, D8) / (F8 * D8)
    topo = TOPOLOGIES[kind](F8)
    sched = T.gossip_schedule(topo, ttl)
    assert T.audit_schedule(topo, ttl, sched).ok

    def acc_of(i, j):
        return float(np.clip(models[j].mean() + 0.5, 0, 1))

    expect, dist = _ball_oracle(models, topo, ttl, acc_of)
    got = np.stack([r[kind, ttl][0] for r in res])
    np.testing.assert_allclose(got, expect, rtol=1e-5)
    received = [r[kind, ttl][2]["models_received"] for r in res]
    np.testing.assert_array_equal(received, ((dist >= 1) & (dist <= ttl)).sum(1))
    # one message a (src, dst) pair of each step: the schedule's collectives
    assert sum(r[kind, ttl][3] for r in res) == sum(len(p) for p, _ in sched.steps)
    if kind in ("erdos", "smallworld") and ttl == 2:
        # the chain oracle still runs but under-covers the same ball
        chain = sum(r[kind, 2, "chain"][2]["models_received"] for r in res)
        assert chain < sum(received), kind


def test_degree_one_node_never_punishes_its_only_neighbour():
    res = _spawned(F8)
    topo = _deg1_topology(F8)
    assert (topo.degrees() == 1).any()
    for i in range(F8):
        rep = res[i]["deg1"][1]
        if topo.degrees()[i] == 1:
            np.testing.assert_array_equal(rep, np.ones(F8))
        else:
            assert rep.min() == np.float32(0.95), (i, rep)


# ------------------------------------------------------------- the launcher
def _raises_on_one_rank(rank, dev):
    if rank == 1:
        raise ValueError("rank one fails")
    # the other ranks block in a receive that never comes
    gossip.tree_ppermute({"x": torch.zeros(4)}, None, [(1, rank)])


def _sleeps(rank, dev):
    time.sleep(120)


def _mesh_sizes(rank, dev):
    with pytest.raises(ValueError, match="needs 8 ranks"):
        mesh_lib.make_fed_mesh(4, 2, 1)
    m = mesh_lib.make_fed_mesh(2, 1, 1)
    t = mesh_lib.make_test_mesh(1, 2)
    return (m.mesh_dim_names, mesh_lib.fed_axis_name(m),
            mesh_lib.fed_axis_name(t), torch.distributed.get_world_size(
                mesh_lib.fed_group(m)))


def test_spawn_kills_every_rank_when_one_raises():
    with pytest.raises(RuntimeError, match="rank one fails") as err:
        mesh_lib.spawn(_raises_on_one_rank, 2, device="cpu", timeout=60)
    assert "rank 1 raised" in str(err.value)
    with pytest.raises(TimeoutError, match="did not finish"):
        mesh_lib.spawn(_sleeps, 2, device="cpu", timeout=3)


def test_meshes_name_their_dims():
    names, fed, test_fed, size = mesh_lib.spawn(_mesh_sizes, 2, device="cpu",
                                                timeout=60)
    assert names == ("fed", "data", "model") and fed == "fed"
    assert test_fed == "data" and size == 2
    with pytest.raises(RuntimeError, match="spawn"):
        mesh_lib.make_fed_mesh(1)
    fwd, bwd = gossip.ring_perms(4)
    assert [list(p) for p in T.ring(4).perm_schedule()] == [fwd, bwd]
    print(json.dumps({"ok": True}))
