"""Each cell's control (the reference one precision below the
configuration's, put in the program's place) and the faults a cell can
have, each planted underneath a whole run at a small size on the CPU: all
must come out as not correct under the cells' limits."""

import pytest
import torch

from perfbench import faults, harness
from perfbench.entries import lax_federation, lm_local_steps
from perfbench.tests import _small

torch.set_num_threads(4)
LENET_CELLS = ["lenet5-dfl.n1024", "lenet5-dfl.sweep24x10"]
GLM = "chatglm3-6b.local-steps"


def _lenet_run(cell, seed):
    _, _, c, config = harness.cell_files(harness.ROOT, cell)
    bench = harness.Bench(cell, _small.lenet_cell(cell)(c), config, seed,
                          torch.device("cpu"), 1)
    run = lax_federation.setup(bench)
    run.unit()
    run.release()
    return run


@pytest.mark.parametrize("cell", LENET_CELLS)
def test_lenet_control_tf32_is_not_correct(cell):
    run = _lenet_run(cell, 2 ** 32 + 17)
    assert all(v <= lim for _, v, lim in run.check())
    fails = [k for k, v, lim in run.check(control=lax_federation.tf32_control) if v > lim]
    assert "train_gap" in fails


def test_glm_control_fp8_is_not_correct():
    _, _, c, config = harness.cell_files(harness.ROOT, GLM)
    bench = harness.Bench(GLM, _small.glm_cell(c), _small.glm_config(config), 2 ** 32 + 3,
                          torch.device("cpu"), 1)
    run = lm_local_steps.setup(bench)
    run.release()
    ref = run.reference()
    sound = lm_local_steps.compare(run.prog, ref)
    values = lm_local_steps.compare(run.reference(operands="fp8"), ref)
    limits = c["check"]["limits"]
    # the limits are set at the cell's size, where bf16 reads closer to
    # fp32 than at this one: the control must also stand well above the
    # sound program at this size
    assert any(values[k] > limits[k] and values[k] > 3 * sound[k] for k in limits), \
        (values, sound)


# ------------------------------------------------------------------ faults
@pytest.mark.parametrize("cell", LENET_CELLS)
@pytest.mark.parametrize("fault", sorted(faults.LENET))
def test_lenet_faults_are_not_correct(cell, fault):
    line, _ = harness.run_cell(cell, 2 ** 32 + 29, 0.0, 0, device="cpu",
                               cell_override=_small.lenet_cell(cell),
                               entry_hook=faults.LENET[fault])
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", sorted(faults.GLM))
def test_glm_faults_are_not_correct(fault):
    kw = dict(device="cpu", cell_override=_small.glm_cell, config_override=_small.glm_config)
    sound, _ = harness.run_cell(GLM, 2 ** 32 + 41, 0.0, 0, **kw)
    line, _ = harness.run_cell(GLM, 2 ** 32 + 41, 0.0, 0, entry_hook=faults.GLM[fault], **kw)
    assert not line["correct"], line["checks"]
    # at this size the sound run reads above some full-size limits too:
    # the fault must stand ten times above it on a number it fails
    assert any(v["value"] > v["limit"] and v["value"] > 10 * sound["checks"][k]["value"]
               for k, v in line["checks"].items()), (line["checks"], sound["checks"])
