"""Small shapes of the cells for CPU runs of the whole harness."""
import copy

LENET = {"lenet5-dfl.n1024": (8, 24), "lenet5-dfl.sweep24x10": (10, 24)}


def lenet_cell(name, nodes=None, ticks=None):
    n0, t0 = LENET[name]

    def override(cell):
        cell = copy.deepcopy(cell)
        cell["traffic"].update(nodes=nodes or n0, ticks=ticks or t0)
        cell["check"]["train_sample"] = 48
        return cell
    return override


def glm_cell(cell):
    cell = copy.deepcopy(cell)
    cell["traffic"].update(batch=2, seq=64, pool_rows=40)
    return cell


def glm_config(config):
    config = copy.deepcopy(config)
    config["arch"].update(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                          head_dim=16, d_ff=128, vocab_size=256)
    return config
