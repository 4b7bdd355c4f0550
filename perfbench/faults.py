"""Faults a cell can have, each planted underneath a whole run (the
``entry_hook`` of ``harness.run_cell``): the check must then read the run
as not correct. The tests plant them at small sizes on the CPU,
``readings.py`` at the cells' own sizes on the card."""
from __future__ import annotations

import torch

from perfbench.seeds import derive


# ------------------------------------------------------------ LeNet cells
def _train(run, fn):
    run.rec.orig["train"] = fn(run.rec.orig["train"])


def lenet_unchanged(run):
    """A training that returns its input models."""
    def wrap(orig):
        def train(params, generator, data, rows, ids=None):
            return {k: {kk: x[rows].clone() for kk, x in v.items()} for k, v in params.items()}
        return train
    _train(run, wrap)


def lenet_quarter_unchanged(run):
    """The first quarter of each stacked training call's rows returned
    as they came in: a fault on a minority of the trainings."""
    def wrap(orig):
        def train(params, generator, data, rows, ids=None):
            out = orig(params, generator, data, rows, ids)
            k = max(1, rows.shape[0] // 4)
            return {layer: {name: torch.cat([params[layer][name][rows[:k]], x[k:]])
                            for name, x in leaves.items()}
                    for layer, leaves in out.items()}
        return train
    _train(run, wrap)


def lenet_half_batch(run):
    """Each SGD step on half its batch, the mean taken over the rest."""
    sc = run.sc
    orig = sc.sgd_stacked

    def sgd(models, data, rows, idx):
        return orig(models, data, rows, idx[..., :idx.shape[-1] // 2].contiguous())
    sc.sgd_stacked = sgd


def lenet_answer_altered(run):
    """One receipt's accuracy flipped in every evaluation call, at a row
    drawn anew each call from the run's seed."""
    orig = run.rec.orig["eval"]
    g = torch.Generator().manual_seed(derive(run.bench.seed, "fault"))

    def ev(models, data):
        out = orig(models, data).clone()
        i = int(torch.randint(out.shape[0], (1,), generator=g))
        out[i] = 1.0 - out[i]
        return out
    run.rec.orig["eval"] = ev


LENET = {"unchanged": lenet_unchanged, "quarter_unchanged": lenet_quarter_unchanged,
         "half_batch": lenet_half_batch, "answer_altered": lenet_answer_altered}


# ---------------------------------------------------------------- LM cell
def glm_unchanged(run):
    """A step that returns its state unchanged (its loss still computed)."""
    from repro_torch.models import transformer

    def step(state, batch):
        with torch.no_grad():
            _, metrics = transformer.train_loss(state["params"], run.cfg, batch)
        return state, metrics
    run.step.fn = step
    run.rerun()


def glm_half_batch(run):
    """Each step on half its batch, the mean taken over the rest."""
    orig = run.step.fn

    def step(state, batch):
        return orig(state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
    run.step.fn = step
    run.rerun()


GLM = {"unchanged": glm_unchanged, "half_batch": glm_half_batch}
