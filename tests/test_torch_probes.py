"""The port's five probe kernels against the Pallas kernels of
``experiments/mosaic_probe.py``.

Each probe's plain PyTorch version (``kernels/probes.py``, what the
wrapper runs on CPU tensors and what ``chip_smoke.py`` holds the CUDA
kernel against) must equal the JAX script's own kernel run through
``pl.pallas_call(..., interpret=True)`` on the same seeded [64, 128]
inputs, exactly: every probe is integer arithmetic.  The inputs
(``mosaic_probe.make_inputs``) are full-range int16/int8 planes, int32
values beyond the int16 range and at INT32_MAX for the truncating
store, and merge keys that are negative, DEAD, SUSPECT or tie the
entry's incarnation.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

from scalecube_cluster_tpu_torch import mosaic_probe  # noqa: E402
from scalecube_cluster_tpu_torch.kernels import LAUNCHES, probes  # noqa: E402
from tests.torch_port_helpers import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.torchport

SCRIPT = Path(__file__).resolve().parent.parent / "experiments" / \
    "mosaic_probe.py"
ROWS, COLS = 64, 128


def _script():
    spec = importlib.util.spec_from_file_location("mosaic_probe_tpu", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


TPU = _script()
# Port kernel -> (Pallas kernel, its output dtypes).
PALLAS = {
    "probe_load16": (TPU.k_load16, (jnp.int32,)),
    "probe_store16": (TPU.k_store16, (jnp.int16,)),
    "probe_cmp16": (TPU.k_cmp16, (jnp.int32,)),
    "probe_load8": (TPU.k_load8, (jnp.int32,)),
    "probe_merge_core": (TPU.k_merge_core, (jnp.int16, jnp.int32)),
}


def _pallas(name, inputs):
    kernel, dtypes = PALLAS[name]
    shapes = tuple(jax.ShapeDtypeStruct(tuple(inputs[0].shape), d)
                   for d in dtypes)
    out = pl.pallas_call(kernel, out_shape=shapes if len(shapes) > 1
                         else shapes[0], interpret=True)(
        *(jnp.asarray(t.numpy()) for t in inputs))
    return [np.asarray(o) for o in (out if len(shapes) > 1 else (out,))]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", probes.NAMES)
def test_probe_matches_pallas_kernel(name, seed):
    inputs = mosaic_probe.make_inputs(ROWS, COLS, seed, "cpu")[name]
    want = _pallas(name, inputs)
    got = probes.REFERENCES[name](*inputs)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (7, 129)])
@pytest.mark.parametrize("name", sorted(probes.VECTORISED))
def test_vectorised_probe_matches_pallas_at_ragged_shapes(name, shape):
    """The shapes whose element count is no multiple of 4, 8 or 16,
    where the vectorised kernels run their scalar tail on the card."""
    inputs = mosaic_probe.make_inputs(*shape, 4, "cpu")[name]
    want = _pallas(name, inputs)
    before = dict(LAUNCHES)
    got = probes.PROBES[name](*inputs)
    assert dict(LAUNCHES) == before
    assert got.numpy().dtype == want[0].dtype
    np.testing.assert_array_equal(got.numpy(), want[0])
    np.testing.assert_array_equal(
        probes.REFERENCES[name](*inputs).numpy(), want[0])


def _misaligned(t):
    """``t``'s values in a contiguous view that starts one element past a
    fresh allocation, so ``data_ptr() % 16`` is the element size."""
    view = torch.empty(t.numel() + 1, dtype=t.dtype)[1:].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("name", sorted(probes.VECTORISED))
def test_vectorised_probe_refuses_misaligned_input_on_cpu(name):
    inputs = mosaic_probe.make_inputs(3, 5, 0, "cpu")[name]
    before = dict(LAUNCHES)
    for i, field in zip(range(len(inputs)), "xy"):
        bad = list(inputs)
        bad[i] = _misaligned(inputs[i])
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16
        with pytest.raises(ValueError, match=f"{field} must start on a "
                                             f"16-byte boundary"):
            probes.PROBES[name](*bad)
    assert torch.equal(probes.PROBES[name](*inputs),
                       probes.REFERENCES[name](*inputs))
    assert dict(LAUNCHES) == before


def test_store16_truncates_modulo_2_16():
    """``astype(jnp.int16)`` keeps the low 16 bits; so does the port."""
    x = torch.tensor([[350342, 2**31 - 1, -2**31, 32767, -32769, -1]],
                     dtype=torch.int32)
    assert probes.store16(x).tolist() == [[22663, 0, 1, -32768, -32768, 0]]
    assert _pallas_small(x) == probes.store16(x).tolist()


def _pallas_small(x):
    out = pl.pallas_call(TPU.k_store16, interpret=True, out_shape=(
        jax.ShapeDtypeStruct(tuple(x.shape), jnp.int16)))(jnp.asarray(x.numpy()))
    return np.asarray(out).tolist()


def test_wrappers_take_plain_version_on_cpu_and_check_inputs():
    inputs = mosaic_probe.make_inputs(4, 8, 3, "cpu")
    before = dict(LAUNCHES)
    for name in probes.NAMES:
        got = probes.PROBES[name](*inputs[name])
        want = probes.REFERENCES[name](*inputs[name])
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name
    assert dict(LAUNCHES) == before
    x16 = inputs["probe_load16"][0]
    with pytest.raises(TypeError, match="x"):
        probes.load16(x16.to(torch.int32))
    with pytest.raises(ValueError, match="y"):
        probes.cmp16(x16, x16[:, :4].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        probes.load8(inputs["probe_load8"][0].t())


def test_entry_point_prints_one_line_per_probe(capsys):
    results = mosaic_probe.main(["--rows", "8", "--cols", "16",
                                 "--device", "cpu"])
    lines = [json.loads(line) for line in
             capsys.readouterr().out.strip().splitlines()]
    assert lines == results
    assert [r["probe"] for r in results] == list(probes.NAMES)
    assert all(r["ok"] and r["max_abs_err"] == 0 and r["shape"] == [8, 16]
               for r in results)
    assert results[0]["replaces"] == "experiments/mosaic_probe.py:46 k_load16"


@pytest.mark.parametrize("name", ["probe_load16", "probe_store16",
                                  "probe_cmp16", "probe_load8"])
def test_library_call_equals_plain_version(name):
    """The one PyTorch call ``chip_smoke.py`` times as a probe's library
    yardstick computes the probe's function, dtype included, and the
    widening ones do not wrap at their input type's ends."""
    import chip_smoke

    inputs = mosaic_probe.make_inputs(ROWS, COLS, 2, "cpu")[name]
    if name in ("probe_load16", "probe_load8"):
        info = torch.iinfo(inputs[0].dtype)
        inputs = (torch.cat([inputs[0].flatten(), torch.tensor(
            [info.min, info.max], dtype=inputs[0].dtype)]),)
    got = chip_smoke.PROBE_LIBRARY[name](*inputs)
    want = probes.REFERENCES[name](*inputs)
    assert got.dtype == want.dtype
    assert torch.equal(got, want)

