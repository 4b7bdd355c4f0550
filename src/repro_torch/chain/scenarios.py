"""Federation scenarios and the generic heap-simulator binder.

Port of the JAX package's ``repro.chain.scenarios`` for the heap engine. A
scenario holds its data as numpy (bit-identical to the JAX package's for
the same seed) and satisfies one uniform signature set:

    num_nodes                           -> int
    init_params_stacked(device)         -> params, leaves (N, ...)
    train_data(device)                  -> dict of (N, ...) tensors or None
    eval_data(device)                   -> dict of (N, ...) tensors
    train_fn(params, generator, data)   -> params        (one node)
    eval_fn(params, eval_data_i)        -> accuracy      (receipt measurement)
    test_fn(params)                     -> accuracy      (global test metric)

and their stacked counterparts, which the vectorized engine
(``repro_torch.chain.simlax``) calls on M models at once:

    train_stacked(params, generator, data, rows, ids=None) -> params
        (M, ...): the training actions of rows ``rows`` of the params/data;
        ``ids`` are those rows' node ids when params/data hold a block of
        the federation (the sharded engine), else ``rows``
    eval_stacked(models, eval_data)     -> (M,) accuracies, model m on
                                           eval data row m
    test_stacked(params)                -> (N,) test accuracies

train/eval/test run on the device their params live on. ``train_fn`` draws
its batch indices from the ``torch.Generator`` it is handed (the node's
own); ``train_stacked`` draws all N nodes' indices from the one generator
and keeps those of the nodes it trains, so a node's draw depends neither on
who else trains nor on which block of the federation a process holds. Initial params come from a generator seeded with the scenario's seed,
so they differ from the JAX package's draws; tests carry the JAX params
across with ``repro_torch.convert``.

Scenarios register by name (``scenarios.get("lenet")(n, ...)``), and ONE
generic binder (``make_heap_nodes`` / ``make_heap_simulator``) turns any
scenario plus a ``FederationSpec`` into heap-``Simulator`` nodes on
``device`` (default ``"cuda"``; ``use_kernel=True`` sends each node's Eq. 3
through the wfedavg kernel's wrapper).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Protocol, Sequence, \
    runtime_checkable

import numpy as np
import torch

from repro_torch import device as device_lib
from repro_torch import tree
from repro_torch.chain.attacks import FederationSpec
from repro_torch.chain.node import DFLNode
from repro_torch.configs.lenet_dfl import CONFIG as LENET_CFG
from repro_torch.core import tracecheck
from repro_torch.core.reputation import ReputationImpl
from repro_torch.data.partition import dirichlet_class_probs, iid_class_probs
from repro_torch.data.synthetic import SyntheticMnist
from repro_torch.models import lenet

LR = 0.1
_LR32 = float(np.float32(LR))


@runtime_checkable
class Scenario(Protocol):
    """The contract the simulator engines program against."""

    @property
    def num_nodes(self) -> int: ...

    def init_params_stacked(self, device="cuda"): ...

    def train_data(self, device="cuda"): ...   # dict of (N, ...) or None

    def eval_data(self, device="cuda"): ...    # dict of (N, ...)

    def train_fn(self, params, generator, data): ...

    def eval_fn(self, params, eval_data_i): ...

    def test_fn(self, params): ...

    def train_stacked(self, params, generator, data, rows, ids=None): ...

    def eval_stacked(self, models, eval_data): ...

    def test_stacked(self, params): ...


class _DeviceCache:
    """Per-device tensor copies of a scenario's numpy constants, made once."""

    def __init__(self):
        self._store: Dict[tuple, torch.Tensor] = {}

    def get(self, name: str, array: np.ndarray, dev) -> torch.Tensor:
        key = (name, str(dev))
        if key not in self._store:
            self._store[key] = torch.as_tensor(array, device=dev)
        return self._store[key]


# ================================================================== registry
_REGISTRY: Dict[str, Callable] = {}


def register(name: str, builder: Callable) -> Callable:
    """Register a scenario builder (n, **kwargs) -> Scenario under a name."""
    _REGISTRY[name] = builder
    return builder


def get(name: str) -> Callable:
    """The registered builder: ``scenarios.get("toy")(n, malicious=(0,))``."""
    if name not in _REGISTRY:
        raise KeyError(f"unknown scenario {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def names() -> tuple:
    return tuple(sorted(_REGISTRY))


# ===================================================== generic heap binding
def make_heap_nodes(scenario: Scenario, *, rep_impl: ReputationImpl,
                    ttl: int, seed: int = 0,
                    spec: Optional[FederationSpec] = None,
                    sim_seed: Optional[int] = None,
                    compress: Optional[str] = None,
                    use_kernel: bool = False,
                    device="cuda") -> List[DFLNode]:
    """Bind ANY Scenario to heap-`Simulator` nodes on ``device``: slice the
    stacked params/data per node and wrap the scenario callbacks into the
    node's (params, generator) -> (params, metrics) / params -> float
    conventions. ``spec`` assigns attacker roles (falls back to the
    scenario's ``malicious`` ids with the default gaussian attack).
    ``sim_seed`` wires each attacker to the per-(seed, tick) attack
    generators of ``FederationSpec.attack_key_fns``; None draws attacks
    from the node's own generator. ``compress`` is the wire quantization
    mode; ``use_kernel`` sends each node's Eq. 3 through
    ``repro_torch.kernels.wfedavg.ops.weighted_fedavg_tree``."""
    dev = device_lib.resolve(device)
    n = scenario.num_nodes
    if spec is None:
        spec = FederationSpec.build(
            n, malicious=tuple(getattr(scenario, "malicious", ()) or ()))
    if spec.num_nodes != n:
        raise ValueError(f"spec is for {spec.num_nodes} nodes, scenario has {n}")
    key_fns = {} if sim_seed is None else spec.attack_key_fns(sim_seed, dev)
    stacked = scenario.init_params_stacked(dev)
    tdata = scenario.train_data(dev)
    edata = scenario.eval_data(dev)
    nodes = []
    for i in range(n):
        params_i = tree.map(lambda x, _i=i: x[_i].clone(), stacked)
        data_i = (None if tdata is None
                  else tree.map(lambda x, _i=i: x[_i], tdata))
        ed_i = tree.map(lambda x, _i=i: x[_i], edata)

        def train_fn(p, g, data=data_i):
            return scenario.train_fn(p, g, data), {}

        def eval_fn(p, ed=ed_i):
            return float(scenario.eval_fn(p, ed))

        rng = torch.Generator(device=dev)
        rng.manual_seed(seed * 1000 + i)
        nodes.append(DFLNode(
            name=f"n{i}", model_structure=type(scenario).__name__.lower(),
            params=params_i, train_fn=train_fn, eval_fn=eval_fn,
            rep_impl=rep_impl, ttl=ttl, attack=spec.attack_for(i),
            attack_key_fn=key_fns.get(i), compress=compress,
            use_kernel=use_kernel, rng=rng))
    return nodes


def heap_test_fn(scenario: Scenario) -> Callable:
    """The scenario's global test metric as the heap simulator's
    params -> float callback."""
    def test_fn(p):
        return float(scenario.test_fn(p))

    return test_fn


def make_heap_simulator(scenario: Scenario, topology, spec: FederationSpec,
                        rep_impl: ReputationImpl, cfg, *, seed: int = 0,
                        use_kernel: bool = False, device="cuda"):
    """Construct the heap `Simulator` from a (scenario, topology, spec,
    rep_impl, SimLaxConfig) tuple, with its nodes on ``device``. The scalar
    per-hop latency becomes the heap's (lo, hi) = (l, l)."""
    from repro_torch.chain.network import SimConfig, Simulator
    nodes = make_heap_nodes(scenario, rep_impl=rep_impl, ttl=cfg.ttl,
                            seed=seed, spec=spec, sim_seed=cfg.seed,
                            compress=getattr(cfg, "compress", None),
                            use_kernel=use_kernel, device=device)
    names_ = [nd.name for nd in nodes]
    sim = Simulator(
        nodes, topology.as_name_dict(names_), heap_test_fn(scenario),
        SimConfig(ticks=cfg.ticks, train_interval=cfg.train_interval,
                  latency=(cfg.latency, cfg.latency),
                  record_every=cfg.record_every, seed=cfg.seed))
    if spec.initial_countdown is not None:
        sim.next_train = {names_[i]: spec.initial_countdown[i]
                          for i in range(len(names_))}
    for i, factor in spec.stragglers:
        sim.set_straggler(names_[i], factor)
    for i in spec.dead:
        sim.kill_node(names_[i])
    if spec.membership is not None:
        sim.set_membership(spec.membership, names=names_)
    return sim


# ======================================================================= toy
@dataclasses.dataclass
class ToyScenario:
    """A D-dim vector pulled toward a target by each local train step
    (deterministic): ``w <- w + LR * (target - w)``; receipt and test
    accuracy ``clip(1 - mean|w - target|, 0, 1)``."""
    dim: int
    target: np.ndarray           # (dim,)
    init_w: np.ndarray           # (n, dim) per-node initial params
    malicious: tuple
    _cache: _DeviceCache = dataclasses.field(
        default_factory=_DeviceCache, repr=False, compare=False)

    @property
    def num_nodes(self) -> int:
        return self.init_w.shape[0]

    def init_params_stacked(self, device="cuda"):
        return {"w": torch.as_tensor(self.init_w, device=device_lib.resolve(device))}

    def train_data(self, device="cuda"):
        return None              # the toy train step needs no local data

    def eval_data(self, device="cuda"):
        n = self.init_w.shape[0]
        t = self._cache.get("target", self.target, device_lib.resolve(device))
        return t.expand(n, self.dim)

    def train_fn(self, params, generator, data=None):
        del generator, data
        return {"w": self._step(params["w"])}

    def _step(self, w):
        """``w + LR * (target - w)`` as one fused multiply-add, rounded once
        (through float64: the float32 product is exact there), as the JAX
        package's compiled step computes it."""
        d = self._cache.get("target", self.target, w.device) - w
        return (w.double() + _LR32 * d.double()).to(w.dtype)

    def eval_fn(self, params, ref):
        return torch.clamp(1.0 - torch.mean(torch.abs(params["w"] - ref)), 0.0, 1.0)

    def test_fn(self, params):
        return self.eval_fn(
            params, self._cache.get("target", self.target, params["w"].device))

    def train_stacked(self, params, generator, data, rows, ids=None):
        del generator, data, ids
        return {"w": self._step(params["w"][rows])}

    def eval_stacked(self, models, refs):
        return torch.clamp(
            1.0 - torch.mean(torch.abs(models["w"] - refs), dim=-1), 0.0, 1.0)

    def test_stacked(self, params):
        w = params["w"]
        return self.eval_stacked(
            params, self._cache.get("target", self.target, w.device).expand_as(w))


def toy_scenario(n: int, dim: int = 16, malicious: Sequence[int] = (),
                 seed: int = 0) -> ToyScenario:
    rng = np.random.RandomState(seed)
    target = np.full((dim,), 0.8, np.float32)
    # nodes start spread BELOW the target so the acc curve visibly climbs
    init_w = (0.1 + 0.05 * rng.rand(n, 1) + 0.01 * rng.rand(n, dim)) \
        .astype(np.float32)
    return ToyScenario(dim=dim, target=target, init_w=init_w,
                       malicious=tuple(malicious))


# =========================================================== real-model (LeNet)
@dataclasses.dataclass
class LeNetScenario:
    """Paper §VI-D at federation scale: LeNet-5, non-I.I.D. Dirichlet shards,
    receipt accuracy on the receiver's own held-out data. ``malicious`` names
    the default attacker set (gaussian random-model poisoning, the paper's
    §VI-E attack); richer adversaries come from a ``FederationSpec``."""

    class_probs: np.ndarray      # (n, classes) per-node label distribution
    train_images: np.ndarray     # (n, P, 28, 28, 1) local training pools
    train_labels: np.ndarray     # (n, P)
    eval_images: np.ndarray      # (n, E, 28, 28, 1) receipt-eval held-out sets
    eval_labels: np.ndarray      # (n, E)
    test_images: np.ndarray      # (T, 28, 28, 1) global I.I.D. test set
    test_labels: np.ndarray      # (T,)
    malicious: tuple
    train_steps: int             # SGD steps per training action
    batch: int
    lr: float
    seed: int
    _cache: _DeviceCache = dataclasses.field(
        default_factory=_DeviceCache, repr=False, compare=False)
    _graphs: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    @property
    def num_nodes(self) -> int:
        return self.train_images.shape[0]

    def init_params_stacked(self, device="cuda"):
        dev = device_lib.resolve(device)
        g = torch.Generator(device=dev)
        g.manual_seed(self.seed)
        per_node = [lenet.init(g, LENET_CFG, dev) for _ in range(self.num_nodes)]
        return tree.map(lambda *xs: torch.stack(xs), *per_node)

    def train_data(self, device="cuda"):
        dev = device_lib.resolve(device)
        return {"images": torch.as_tensor(self.train_images, device=dev),
                "labels": torch.as_tensor(self.train_labels, device=dev)}

    def eval_data(self, device="cuda"):
        dev = device_lib.resolve(device)
        return {"images": torch.as_tensor(self.eval_images, device=dev),
                "labels": torch.as_tensor(self.eval_labels, device=dev)}

    def train_fn(self, params, generator, data):
        """`train_steps` plain-SGD steps on batches resampled from this
        node's pool; the indices come from ``generator``."""
        if self.train_steps == 0:
            return params
        pool = data["labels"].shape[0]
        idx = torch.randint(0, pool, (self.train_steps, self.batch),
                            generator=generator, device=generator.device)
        return self.sgd(params, data, idx.to(data["labels"].device))

    def sgd(self, params, data, idx):
        """One node's SGD steps, step s on its pool rows ``idx[s]``."""
        p = params
        for ix in idx:
            batch = {"images": data["images"][ix], "labels": data["labels"][ix]}
            leaves = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
            loss, _ = lenet.loss_and_acc(tree.unflatten(p, leaves), batch)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                p = tree.unflatten(
                    p, [a - self.lr * g for a, g in zip(leaves, grads)])
        return p

    def train_stacked(self, params, generator, data, rows, ids=None):
        """The training actions of rows ``rows`` of params/data at once:
        the (N, train_steps, batch) pool indices of all N nodes come from
        ``generator`` and row k keeps node ``ids[k]``'s (default: ``rows``,
        when params/data hold the whole federation)."""
        models = tree.map(lambda x: x[rows], params)
        if self.train_steps == 0:
            return models
        pool = data["labels"].shape[1]
        idx = torch.randint(0, pool, (self.num_nodes, self.train_steps,
                                      self.batch),
                            generator=generator, device=generator.device)
        ids = rows if ids is None else ids
        return self.sgd_stacked(models, data, rows,
                                idx.to(data["labels"].device)[ids])

    def sgd_stacked(self, models, data, rows, idx):
        """M models' SGD steps at once: model m trains on pool ``rows[m]``,
        step s on its rows ``idx[m, s]``. On the card, calls of at most
        ``GRAPH_MODELS`` models replay one captured CUDA graph a model
        count (the same kernels at the same shapes, a few launches in
        place of hundreds); larger calls, and the CPU, run eagerly."""
        if _graphed(rows):
            # all steps' batches at once, step-major: (steps, M, batch, ...)
            pick = (rows[None, :, None], idx.transpose(0, 1))
            images, labels = data["images"][pick], data["labels"][pick]
            key = (rows.shape[0], tuple(idx.shape[1:]), str(rows.device),
                   torch.backends.cudnn.deterministic)
            if key not in self._graphs:
                self._graphs[key] = _SGDGraph(self, models, images, labels)
            return self._graphs[key](models, images, labels)

        def batch(s):
            pick = (rows[:, None], idx[:, s])
            return {"images": data["images"][pick], "labels": data["labels"][pick]}

        return self._sgd_steps(models, batch, idx.shape[1])

    def _sgd_steps(self, models, batch, steps):
        """``steps`` SGD steps of the stacked models, step s on ``batch(s)``."""
        p = models
        for s in range(steps):
            leaves = [x.detach().requires_grad_(True) for x in tree.leaves(p)]
            losses = lenet.losses_stacked(tree.unflatten(p, leaves), batch(s))
            grads = torch.autograd.grad(losses.sum(), leaves)
            with torch.no_grad():
                p = tree.unflatten(
                    p, [a - self.lr * g for a, g in zip(leaves, grads)])
        return p

    def eval_fn(self, params, ed):
        with torch.no_grad():
            return lenet.accuracy(params, ed["images"], ed["labels"])

    def test_fn(self, params):
        dev = device_lib.of(params)
        with torch.no_grad():
            return lenet.accuracy(
                params, self._cache.get("test_images", self.test_images, dev),
                self._cache.get("test_labels", self.test_labels, dev))

    def eval_stacked(self, models, ed):
        return _accuracy_chunked(models, ed["images"], ed["labels"])

    def test_stacked(self, params):
        dev = device_lib.of(params)
        n = tree.leaves(params)[0].shape[0]
        images = self._cache.get("test_images", self.test_images, dev)
        labels = self._cache.get("test_labels", self.test_labels, dev)
        return _accuracy_chunked(params, images.expand(n, *images.shape),
                                 labels.expand(n, *labels.shape))


# model-image pairs a stacked forward takes at once: bounds the activations
# of an evaluation over many models (2**17 pairs: ~2.5 GB for conv1's)
EVAL_PAIRS = 1 << 17

# the largest stacked SGD call that runs as a captured CUDA graph: below it
# the call is bound by the host's launches (a few trainers a tick, or one
# member of a batch), above it by the card
GRAPH_MODELS = 32


def _graphed(rows) -> bool:
    """Whether a stacked SGD call over ``rows`` replays a CUDA graph."""
    return rows.is_cuda and rows.shape[0] <= GRAPH_MODELS


class _SGDGraph:
    """``LeNetScenario._sgd_steps`` over M stacked models, captured once as
    a CUDA graph: a call copies the models and the steps' batches into the
    graph's input buffers, replays it and copies the trained models out.
    Warm-up runs on a side stream before the capture, as CUDA graphs
    require. Each construction is one capture
    (``tracecheck.get_counter("chain.scenarios.sgd_graph")``)."""

    @tracecheck.count_captures(name="chain.scenarios.sgd_graph")
    def __init__(self, scenario, models, images, labels):
        self.models = tree.map(torch.clone, models)
        self.images, self.labels = images.clone(), labels.clone()
        steps = images.shape[0]

        def batch(s):
            return {"images": self.images[s], "labels": self.labels[s]}

        side = torch.cuda.Stream(device=images.device)
        side.wait_stream(torch.cuda.current_stream(images.device))
        with torch.cuda.stream(side):
            scenario._sgd_steps(self.models, batch, steps)
        torch.cuda.current_stream(images.device).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = scenario._sgd_steps(self.models, batch, steps)

    def __call__(self, models, images, labels):
        for dst, src in zip(tree.leaves(self.models), tree.leaves(models)):
            dst.copy_(src)
        self.images.copy_(images)
        self.labels.copy_(labels)
        self.graph.replay()
        return tree.map(torch.clone, self.out)


def _accuracy_chunked(models, images, labels):
    """(M,) accuracies, model m on images[m] / labels[m], EVAL_PAIRS
    model-image pairs a forward."""
    m, b = labels.shape
    step = max(1, EVAL_PAIRS // b)
    with torch.no_grad():
        return torch.cat([
            lenet.accuracy_stacked(
                tree.map(lambda x, i=i: x[i:i + step], models),
                images[i:i + step], labels[i:i + step])
            for i in range(0, m, step)])


def lenet_scenario(n: int, *, alpha: float = 1.0,
                   malicious: Sequence[int] = (), seed: int = 0,
                   pool: int = 256, eval_size: int = 64,
                   test_size: int = 512, train_steps: int = 2,
                   batch: int = 32, noise: float = 1.5,
                   lr: float = 0.1) -> LeNetScenario:
    """Build the §VI-D federation data: Dirichlet(alpha) label shards
    (``alpha=None`` -> I.I.D.), per-node train pools and held-out receipt
    sets drawn from the node's OWN distribution, one global I.I.D. test set.
    Same numpy draws as the JAX package's ``lenet_scenario``."""
    ds = SyntheticMnist(seed=seed, noise=noise)
    if alpha is None:
        probs = iid_class_probs(n, ds.num_classes)
    else:
        probs = dirichlet_class_probs(n, ds.num_classes, alpha, seed=seed)
    tr_i = np.empty((n, pool, ds.image_size, ds.image_size, 1), np.float32)
    tr_l = np.empty((n, pool), np.int32)
    ev_i = np.empty((n, eval_size, ds.image_size, ds.image_size, 1),
                    np.float32)
    ev_l = np.empty((n, eval_size), np.int32)
    for i in range(n):
        rng = np.random.RandomState(seed * 100 + i)
        tr_i[i], tr_l[i] = ds.batch(rng, pool, class_probs=probs[i])
        ev_i[i], ev_l[i] = ds.batch(
            np.random.RandomState(seed * 100 + i + 5000), eval_size,
            class_probs=probs[i])
    te_i, te_l = ds.batch(np.random.RandomState(9999), test_size)
    return LeNetScenario(
        class_probs=probs, train_images=tr_i, train_labels=tr_l,
        eval_images=ev_i, eval_labels=ev_l,
        test_images=te_i.astype(np.float32), test_labels=te_l.astype(np.int32),
        malicious=tuple(malicious), train_steps=train_steps, batch=batch,
        lr=lr, seed=seed)


register("toy", toy_scenario)
register("lenet", lenet_scenario)


# the calibrated §VI-D data/optimizer recipe
LENET_PAPER_HP = dict(alpha=1.0, pool=384, eval_size=16, test_size=256,
                      batch=16, lr=0.12)


def lenet_paper_setup(n: int = 10, *, ticks: int = 108, train_steps: int = 8,
                      seed: int = 0, delivery: str = "compact",
                      compress: Optional[str] = None):
    """The calibrated §VI-D recipe: 20% poisoned senders, Dirichlet(1)
    shards, kregular(n, 2) ttl=2, the SGD hyperparameters of
    ``LENET_PAPER_HP``, 108 ticks.

    Returns (scenario, spec, topology, SimLaxConfig).
    """
    from repro_torch.chain import simlax
    from repro_torch.core import topology as topology_lib
    mal = tuple(range(max(1, n // 5)))      # 20% poisoned senders
    sc = lenet_scenario(n, malicious=mal, seed=seed,
                        train_steps=train_steps, **LENET_PAPER_HP)
    topo = topology_lib.kregular(n, 2)
    cfg = simlax.SimLaxConfig(ticks=ticks, train_interval=(6, 6), latency=1,
                              ttl=2, record_every=12, seed=seed,
                              delivery=delivery, compress=compress)
    countdown = [3 + (5 * i) % 6 for i in range(n)]
    spec = FederationSpec.build(n, malicious=mal,
                                initial_countdown=countdown)
    return sc, spec, topo, cfg
