"""The port's kernel packages on the CPU: their plain versions held against
the JAX package's Pallas kernels (interpret mode) on the same numpy inputs,
their wrappers' CPU dispatch, and the no-fallback rules (CPU tensors never
count a launch; asking for CUDA where there is none raises). The CUDA
kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import _torch_threads  # noqa: E402,F401  (torch's threads a worker)
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels.quantize.quantize import dequantize as j_dequantize  # noqa: E402
from repro.kernels.quantize.quantize import quantize as j_quantize      # noqa: E402
from repro.kernels.wfedavg import ops as j_wf_ops                       # noqa: E402
from repro.kernels.wfedavg.wfedavg import wfedavg_flat as j_wfedavg_flat  # noqa: E402

from repro_torch import tree                                           # noqa: E402
from repro_torch.kernels import LAUNCHES, build, reset_launches        # noqa: E402
from repro_torch.kernels.quantize import ops as q_ops                  # noqa: E402
from repro_torch.kernels.quantize.ref import dequantize_ref, quantize_ref  # noqa: E402
from repro_torch.kernels.wfedavg import ops as wf_ops                  # noqa: E402
from repro_torch.kernels.wfedavg.ref import wfedavg_ref                # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


# ------------------------------------------------------------------ quantize
@pytest.mark.parametrize("rows,cols,br", [(256, 256, 256), (64, 120, 64),
                                          (32, 6, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_ref_matches_pallas(rows, cols, br, dtype):
    x32 = (3.0 * np.random.RandomState(rows + cols).standard_normal(
        (rows, cols))).astype(np.float32)
    xj = jnp.asarray(x32).astype(getattr(jnp, dtype))
    xt = _t(x32).to(getattr(torch, dtype))
    jq, js = j_quantize(xj, block_rows=br, interpret=True)
    pq, ps = quantize_ref(xt)
    jq, js = np.asarray(jq), np.asarray(js)
    if dtype == "float32":
        np.testing.assert_array_equal(pq.numpy(), jq)
        np.testing.assert_array_equal(ps.numpy(), js)
    else:
        # the rule of tests/test_kernels.py for bf16 inputs: 1-LSB flips on
        # <1% of elements, scales at rtol 1e-5
        diff = np.abs(pq.numpy().astype(np.int32) - jq.astype(np.int32))
        assert diff.max() <= 1
        assert (diff > 0).mean() < 0.01
        np.testing.assert_allclose(ps.numpy(), js, rtol=1e-5)
    # dequantize held bitwise on the same (q, scales)
    jd = np.asarray(j_dequantize(jnp.asarray(jq), jnp.asarray(js),
                                 block_rows=br, interpret=True))
    pd = dequantize_ref(_t(jq), _t(js))
    np.testing.assert_array_equal(pd.numpy(), jd)


def test_quantize_flat_roundtrip_on_cpu():
    x = _t((np.random.RandomState(5).standard_normal(1000)).astype(np.float32))
    q, s, d = q_ops.quantize_flat(x)
    assert tuple(q.shape) == (4, 256) and tuple(s.shape) == (4, 1) and d == 1000
    back = q_ops.dequantize_flat(q, s, d)
    assert tuple(back.shape) == (1000,)
    assert float((back - x).abs().max() / x.abs().max()) < 0.01
    with pytest.raises(ValueError):
        q_ops.quantize_rows(x)          # 1-D is not (R, C)


# ------------------------------------------------------------------- wfedavg
@pytest.mark.parametrize("n,d", [(2, 2048), (10, 8192), (5, 4096)])
def test_wfedavg_ref_matches_pallas(n, d):
    rng = np.random.RandomState(n * d)
    ms = rng.standard_normal((n, d)).astype(np.float32)
    prev = rng.standard_normal((d,)).astype(np.float32)
    wn = rng.rand(n).astype(np.float32)
    wn /= wn.sum()
    want = np.asarray(j_wfedavg_flat(jnp.asarray(ms), jnp.asarray(wn),
                                     jnp.asarray(prev), block_cols=2048,
                                     interpret=True))
    got = wf_ops.wfedavg_flat(_t(ms), _t(wn), _t(prev))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.numpy(), wfedavg_ref(_t(ms), _t(wn),
                                                        _t(prev)).numpy())


@pytest.mark.parametrize("weights", [[0.1, 0.4, 0.0, 0.5], [0.0, 0.0, 0.0, 0.0]])
def test_weighted_fedavg_tree_matches_jax_ops(weights):
    """Leaves on both sides of the 4096-element kernel threshold, a ragged
    one (no 2048-column padding in the port), and the zero-weight case."""
    rng = np.random.RandomState(2)
    ms = {"w": rng.standard_normal((4, 128, 64)).astype(np.float32),
          "r": rng.standard_normal((4, 4099)).astype(np.float32),
          "b": rng.standard_normal((4, 16)).astype(np.float32)}
    prev = {"w": np.zeros((128, 64), np.float32),
            "r": rng.standard_normal((4099,)).astype(np.float32),
            "b": np.ones((16,), np.float32)}
    w = np.asarray(weights, np.float32)
    want = j_wf_ops.weighted_fedavg_tree(jax.tree.map(jnp.asarray, ms),
                                         jnp.asarray(w),
                                         jax.tree.map(jnp.asarray, prev))
    got = wf_ops.weighted_fedavg_tree(tree.map(_t, ms), _t(w), tree.map(_t, prev))
    for k in ms:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)
        assert got[k].dtype == torch.float32


# ------------------------------------------------------- dispatch and rules
def test_cpu_tensors_never_launch_a_kernel():
    reset_launches()
    x = _t(np.random.RandomState(0).standard_normal((9, 40)).astype(np.float32))
    q, s = q_ops.quantize_rows(x)
    q_ops.dequantize_rows(q, s)
    wf_ops.wfedavg_flat(x, torch.full((9,), 1 / 9), x[0])
    assert sum(LAUNCHES.values()) == 0


def test_cuda_requested_without_cuda_raises(monkeypatch):
    from repro_torch import device as device_lib
    from repro_torch.chain import scenarios
    from repro_torch.core.reputation import IMPL2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_lib.resolve("cuda")
    sc = scenarios.toy_scenario(3)
    with pytest.raises(RuntimeError, match="cuda"):
        scenarios.make_heap_nodes(sc, rep_impl=IMPL2, ttl=2)   # default device
    assert device_lib.resolve("cpu").type == "cpu"


def test_kernel_build_command_targets_hopper():
    cmd = " ".join(str(c) for c in build.nvcc_command("quantize",
                                                      build.BUILD_DIR / "x.so"))
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "fast_math" not in cmd and "-shared" in cmd
    import importlib
    import pkgutil
    from repro_torch import kernels
    tables = [importlib.import_module(f"repro_torch.kernels.{m.name}.ops").ENTRIES
              for m in pkgutil.iter_modules(kernels.__path__) if m.ispkg]
    assert set(build.SOURCES) == {p.stem for p in build.CSRC.glob("*.cu")}
    for name in build.SOURCES:
        assert (build.CSRC / f"{name}.cu").is_file()
        assert build.library_path(name).parent == build.BUILD_DIR
        # one wrapper declares the source's C entries, at least one
        owners = [t[name] for t in tables if name in t]
        assert len(owners) == 1 and set(owners[0])


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """An edited header under csrc/ renames every library, so the next call
    rebuilds instead of loading a stale one; the sources stay as they are."""
    import shutil
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    assert (csrc / "sm90.cuh").is_file()
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build.library_path(n) for n in build.SOURCES}
    assert before == {n: build.library_path(n) for n in build.SOURCES}
    header = csrc / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert all(after[n] != before[n] for n in build.SOURCES)
    (csrc / "extra.cuh").write_bytes(b"// new header\n")
    assert build.library_path("flash_attention_sm90") != after["flash_attention_sm90"]
