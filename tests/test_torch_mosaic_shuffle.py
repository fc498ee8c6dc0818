"""K7 on the CPU: each case of the Mosaic probe (``probe_mosaic_shuffle.py``)
through the port's plain PyTorch version, against the case's numpy ``ref``
and inputs, read by executing the case's own body from
``probe_mosaic_shuffle.CASES`` with its Pallas kernel in interpret mode.

Interpret mode runs every case here. For 11 of the 13 its output equals the
``ref``, and the port is held against it too. Two cases' Pallas kernels
compute something else than their ``ref`` outside the TPU, so the port
follows the ``ref`` (what the case asks of the primitive):

* ``repeat_lanes``: interpret mode's ``pltpu.repeat`` tiles the lanes
  (``np.tile``); the ``ref`` is ``np.repeat``'s element repeat.
* ``interleave3_vreg``: XLA clamps the kernel's 128-lane ``dynamic_slice``
  of a 128-lane plane to offset 0, so output lanes 128-383 (output vregs
  1 and 2) differ; lanes 0-127 equal the ``ref``.

The CUDA kernels run on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import probe_mosaic_shuffle
from rustcv_tpu_torch.ops import kernels
from rustcv_tpu_torch.ops.kernels import mosaic_shuffle as k7
from rustcv_tpu_torch.probes import mosaic_shuffle as probe

torch.set_num_threads(2)

NAMES = list(probe_mosaic_shuffle.CASES)
INPUT_NAMES = {"u8_select": ("x", "y"), "interleave3_vreg": ("ws",)}
# Cases whose interpret-mode output is not their ref: what it is instead.
INTERPRET_DIFFERS = {
    "repeat_lanes": lambda out, ns: np.testing.assert_array_equal(
        out, np.tile(np.asarray(ns["x"]), (1, 3))),
    "interleave3_vreg": lambda out, ns: np.testing.assert_array_equal(
        out[:, :128], ns["ref"][:, :128]),
}


def _interpret_call(kern, out_shape, out_dtype, *args):
    return pl.pallas_call(kern, out_shape=jax.ShapeDtypeStruct(out_shape, out_dtype),
                          interpret=True)(*args)


def _run_jax_case(name):
    """Execute the case's body: its inputs, ``out`` (interpret mode), ``ref``."""
    ns = dict(np=np, jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, call=_interpret_call)
    exec(probe_mosaic_shuffle.CASES[name], ns)
    return ns


def _jax_inputs(name, ns):
    arrays = []
    for key in INPUT_NAMES.get(name, ("x",)):
        v = ns[key]
        arrays += [np.asarray(a) for a in v] if isinstance(v, list) else [np.asarray(v)]
    return arrays


def test_cases_are_the_probe_scripts_in_its_order():
    assert list(k7.CASES) == NAMES and list(probe.PROBES) == NAMES
    assert k7.CASE_IDS == {name: i for i, name in enumerate(NAMES)}


@pytest.mark.parametrize("name", NAMES)
def test_plain_version_equals_the_cases_ref(jax_cpu, name):
    ns = _run_jax_case(name)
    ref = np.asarray(ns["ref"])
    inputs = _jax_inputs(name, ns)
    port_inputs = probe.PROBES[name].inputs()
    for a, b in zip(port_inputs, inputs):
        np.testing.assert_array_equal(a.view(b.dtype), b)  # the same words
    result = probe.run_case(name, torch.device("cpu"))
    np.testing.assert_array_equal(result["ref"], ref)
    assert probe.exact(result), name
    kernels.reset_launch_counts()
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in port_inputs]
    got = k7.mosaic_shuffle(name, *tensors)  # a CPU tensor takes the plain version
    assert kernels.launch_counts()["mosaic_shuffle"] == 0
    assert got.numpy().dtype == ref.dtype
    np.testing.assert_array_equal(got.numpy(), ref)
    out = np.asarray(ns["out"])
    if name in INTERPRET_DIFFERS:
        assert not np.array_equal(out, ref)
        INTERPRET_DIFFERS[name](out, ns)
    else:
        np.testing.assert_array_equal(got.numpy(), out)


def test_wrapper_refuses_bad_inputs():
    x = torch.zeros((8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown case"):
        k7.mosaic_shuffle("lane_shuffle", x)
    with pytest.raises(ValueError, match="takes 2"):
        k7.mosaic_shuffle("u8_select", x.to(torch.uint8))
    with pytest.raises(ValueError, match="int32"):
        k7.mosaic_shuffle("lane_roll", x.to(torch.int64))
    with pytest.raises(ValueError, match="too small"):
        k7.mosaic_shuffle("unaligned_slice", x)
    with pytest.raises(ValueError, match="contiguous"):
        k7.mosaic_shuffle("lane_roll", torch.zeros((128, 8), dtype=torch.int32).t())


def test_probe_entry_point_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert probe.main([]) == 1
    assert probe.main(["no_such_case"]) == 2
    assert "CASE_RESULT" not in capsys.readouterr().out
