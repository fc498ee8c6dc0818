"""The port's ``ops.core_ops`` on tensors and on numpy arrays, against
``rustcv_tpu.ops.core_ops`` on ``jax.Array``s (JAX on the CPU) and on the
same numpy arrays: each image-scale op computes on a tensor's device where
the reference computes on a ``jax.Array``'s, and on the host for numpy.

Tolerances: exact for the layout, integer and comparison ops and for every
numpy path; RTOL (relative) for the float32 device results (``magnitude``,
``phase``, ``cart_to_polar``, ``fast_atan2``, ``polar_to_cart``,
``cube_root``, the float sums), whose transcendental functions and sums
are the framework's own."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustcv_tpu.ops import core_ops as J
from rustcv_tpu_torch.ops import core_ops as P

torch.set_num_threads(2)

RTOL = 2e-6  # float32 results of another framework's sqrt/atan/sin/cos/cbrt
ATOL = 1e-5  # for values near zero (angles, sines)


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _f32(shape, seed, lo=-50.0, hi=50.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _np(x):
    if torch.is_tensor(x):
        return x.numpy()
    return np.asarray(x)


def _same(got, want, tol):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w, tol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if tol:
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64), rtol=RTOL,
                                   atol=ATOL)
    else:
        assert g.dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w)


IMG, GRAY, FL = (23, 35, 3), (23, 35), (17, 29)
CMP = ("eq", "ne", "gt", "ge", "lt", "le")

# name → (call(module, *arrays), input arrays, tolerance on a device)
CASES = {
    "copy_make_border_constant": (lambda M, a: M.copy_make_border(a, 2, 3, 4, 1, "constant", 7),
                                  [_u8(IMG, 1)], 0),
    "split": (lambda M, a: M.split(a), [_u8(IMG, 3)], 0),
    "merge_channels": (lambda M, a, b: M.merge_channels([a, b, a]), [_u8(GRAY, 4), _u8(GRAY, 5)],
                       0),
    "mix_channels": (lambda M, a, b: M.mix_channels([a, b], [2, 3], [0, 2, 3, 0, 1, 4, -1, 1]),
                     [_u8(IMG, 6), _u8(GRAY, 7)], 0),
    "fast_atan2": (lambda M, y, x: M.fast_atan2(y, x), [_f32(FL, 8), _f32(FL, 9)], 1),
    "magnitude": (lambda M, x, y: M.magnitude(x, y), [_f32(FL, 10), _f32(FL, 11)], 1),
    "magnitude_u8": (lambda M, x, y: M.magnitude(x, y), [_u8(GRAY, 12), _u8(GRAY, 13)], 1),
    "phase": (lambda M, x, y: M.phase(x, y), [_f32(FL, 14), _f32(FL, 15)], 1),
    "phase_degrees": (lambda M, x, y: M.phase(x, y, True), [_f32(FL, 16), _f32(FL, 17)], 1),
    "cart_to_polar": (lambda M, x, y: M.cart_to_polar(x, y), [_f32(FL, 18), _f32(FL, 19)], 1),
    "cart_to_polar_degrees": (lambda M, x, y: M.cart_to_polar(x, y, True),
                              [_f32(FL, 20), _f32(FL, 21)], 1),
    "polar_to_cart": (lambda M, m, a: M.polar_to_cart(m, a), [_f32(FL, 22, 0, 10),
                                                              _f32(FL, 23, -7, 7)], 1),
    "polar_to_cart_degrees": (lambda M, m, a: M.polar_to_cart(m, a, True),
                              [_f32(FL, 24, 0, 10), _f32(FL, 25, 0, 360)], 1),
    "reduce_sum_rows": (lambda M, a: M.reduce_mat(a, 0, "sum"), [_u8(GRAY, 26)], 0),
    "reduce_avg_cols": (lambda M, a: M.reduce_mat(a, 1, "avg"), [_u8(GRAY, 27)], 1),
    "reduce_max": (lambda M, a: M.reduce_mat(a, 0, "max"), [_u8(GRAY, 28)], 0),
    "reduce_min": (lambda M, a: M.reduce_mat(a, 1, "min"), [_f32(FL, 29)], 0),
    "sort_rows": (lambda M, a: M.sort_mat(a, 1), [_u8(GRAY, 30) // 16], 0),
    "sort_cols_descending": (lambda M, a: M.sort_mat(a, 0, True), [_f32(FL, 31)], 0),
    "sort_idx": (lambda M, a: M.sort_idx(a, 1), [_u8(GRAY, 32) // 16], 0),
    "sort_idx_descending": (lambda M, a: M.sort_idx(a, 0, True), [_f32(FL, 33)], 0),
    "hconcat": (lambda M, a, b: M.hconcat([a, b]), [_u8(GRAY, 34), _u8(GRAY, 35)], 0),
    "vconcat": (lambda M, a, b: M.vconcat([a, b, a]), [_u8(IMG, 36), _u8(IMG, 37)], 0),
    "repeat_mat": (lambda M, a: M.repeat_mat(a, 2, 3), [_u8(IMG, 38)], 0),
    "gemm": (lambda M, a, b, c: M.gemm(a, b, 0.5, c, 2.0, transpose_b=True),
             [_f32((5, 7), 39), _f32((6, 7), 40), _f32((5, 6), 41)], 1),
    "accumulate": (lambda M, s, d: M.accumulate(s, d), [_u8(IMG, 42), _f32(IMG, 43)], 0),
    "accumulate_masked": (lambda M, s, d, m: M.accumulate(s, d, m),
                          [_u8(GRAY, 44), _f32(GRAY, 45), _u8(GRAY, 46) > 128], 0),
    "accumulate_square": (lambda M, s, d: M.accumulate_square(s, d), [_u8(IMG, 47),
                                                                       _f32(IMG, 48)], 0),
    "accumulate_product": (lambda M, a, b, d: M.accumulate_product(a, b, d),
                           [_u8(GRAY, 49), _u8(GRAY, 50), _f32(GRAY, 51)], 0),
    "blend_linear": (lambda M, a, b, w1, w2: M.blend_linear(a, b, w1, w2),
                     [_u8(GRAY, 52), _u8(GRAY, 53), _f32(GRAY, 54, 0, 1), _f32(GRAY, 55, 0, 1)],
                     0),
    "box_filter": (lambda M, a: M.box_filter(a, 5), [_u8(IMG, 56)], 0),
    "box_filter_unnormalized": (lambda M, a: M.box_filter(a, (3, 5), False, "replicate"),
                                [_u8(GRAY, 57)], 1),
    "blur_wrap": (lambda M, a: M.blur(a, (7, 3), "wrap"), [_u8(IMG, 58)], 0),
    "blur_reflect": (lambda M, a: M.blur(a, 4, "reflect"), [_u8(GRAY, 59)], 0),
    "sqr_box_filter": (lambda M, a: M.sqr_box_filter(a, 3), [_u8(GRAY, 60)], 1),
    "cube_root": (lambda M, a: M.cube_root(a), [_f32(FL, 61, -1e4, 1e4)], 1),
    "insert_channel": (lambda M, p, d: M.insert_channel(p, d, 1), [_u8(GRAY, 62), _u8(IMG, 63)],
                       0),
    "extract_channel": (lambda M, a: M.extract_channel(a, 2), [_u8(IMG, 64)], 0),
    "has_non_zero": (lambda M, a: np.array(M.has_non_zero(a)), [_u8(GRAY, 65) // 255], 0),
    "has_non_zero_empty": (lambda M, a: np.array(M.has_non_zero(a)), [np.zeros(GRAY, np.uint8)],
                           0),
    "patch_nans": (lambda M, a: M.patch_nans(a, -1.0),
                   [np.where(_u8(FL, 66) > 200, np.nan, _f32(FL, 67)).astype(np.float32)], 0),
    "reduce_arg_max": (lambda M, a: M.reduce_arg_max(a, 1), [_u8(GRAY, 68) // 32], 0),
    "reduce_arg_max_last": (lambda M, a: M.reduce_arg_max(a, 0, True), [_u8(GRAY, 69) // 32], 0),
    "reduce_arg_min": (lambda M, a: M.reduce_arg_min(a, 1, True), [_f32(FL, 70).round()], 0),
    "transpose_mat": (lambda M, a: M.transpose_mat(a), [_u8(IMG, 71)], 0),
    "multiply_u8": (lambda M, a, b: M.multiply_u8(a, b, 1 / 64), [_u8(IMG, 72), _u8(IMG, 73)], 0),
    "divide_u8": (lambda M, a, b: M.divide_u8(a, b, 32.0), [_u8(IMG, 74), _u8(IMG, 75) // 4], 0),
    "copy_to": (lambda M, s, m: M.copy_to(s, m), [_u8(IMG, 76), _u8(GRAY, 77) > 100], 0),
    "copy_to_dst": (lambda M, s, m, d: M.copy_to(s, m, d),
                    [_u8(GRAY, 78), _u8(GRAY, 79) > 100, _u8(GRAY, 80)], 0),
    "flip_nd": (lambda M, a: M.flip_nd(a, 1), [_u8(IMG, 81)], 0),
    "transpose_nd": (lambda M, a: M.transpose_nd(a, (2, 0, 1)), [_u8(IMG, 82)], 0),
    "finite_mask": (lambda M, a: M.finite_mask(a),
                    [np.where(_u8((9, 11, 3), 83) > 220, np.inf, 1.0).astype(np.float32)], 0),
    "threshold_with_mask": (lambda M, s, m: M.threshold_with_mask(s, m, 100, 255),
                            [_u8(GRAY, 84), _u8(GRAY, 85) > 128], 0),
    "threshold_with_mask_inv": (lambda M, s, m: M.threshold_with_mask(s, m, 60.5, 200, True),
                                [_u8(GRAY, 86), _u8(GRAY, 87) > 64], 0),
}
for _b in ("replicate", "reflect", "reflect101", "wrap"):
    CASES[f"copy_make_border_{_b}"] = (
        lambda M, a, b=_b: M.copy_make_border(a, 3, 1, 2, 5, b), [_u8(IMG, 2)], 0)
    CASES[f"copy_make_border_{_b}_wide"] = (  # borders wider than the image
        lambda M, a, b=_b: M.copy_make_border(a, 9, 7, 11, 6, b), [_u8((4, 5), 2)], 0)
for _op in CMP:
    CASES["compare_" + _op] = (lambda M, a, b, o=_op: M.compare(a, b, o),
                               [_u8(GRAY, 88) // 64, _u8(GRAY, 89) // 64], 0)


@pytest.mark.parametrize("name", list(CASES))
def test_tensor_path_matches_the_jax_path(name):
    call, inputs, tol = CASES[name]
    got = call(P, *(torch.from_numpy(np.ascontiguousarray(a)) for a in inputs))
    for g in (got if isinstance(got, (list, tuple)) else [got]):
        assert torch.is_tensor(g) or isinstance(g, np.ndarray), type(g)
    _same(got, call(J, *(jnp.asarray(a) for a in inputs)), tol)


@pytest.mark.parametrize("name", list(CASES))
def test_numpy_path_is_the_references(name):
    call, inputs, _ = CASES[name]
    _same(call(P, *(a.copy() for a in inputs)), call(J, *(a.copy() for a in inputs)), 0)


def test_cube_root_is_close_to_the_float64_root():
    x = np.concatenate([_f32((200,), 90, -1e6, 1e6), np.float32([0, -0.0, 1e-30, -8, 27]),
                        np.float32([np.inf, -np.inf])])
    got = P.cube_root(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, np.cbrt(x.astype(np.float64)), rtol=RTOL)


def test_fast_atan2_scalars_stay_scalars():
    for y, x in ((1.0, 2.0), (-3.0, -0.5), (0.0, 0.0)):
        assert P.fast_atan2(y, x) == J.fast_atan2(y, x)
    got = P.fast_atan2(torch.tensor([1.0, -2.0]), np.float32([3.0, -4.0]))
    np.testing.assert_allclose(got.numpy(), J.fast_atan2(np.float32([1.0, -2.0]),
                                                         np.float32([3.0, -4.0])), rtol=RTOL)


def test_div_spectrums():
    rng = np.random.default_rng(91)
    a = (rng.normal(size=(6, 8)) + 1j * rng.normal(size=(6, 8))).astype(np.complex64)
    b = (rng.normal(size=(6, 8)) + 1j * rng.normal(size=(6, 8))).astype(np.complex64)
    for conj in (False, True):
        got = P.div_spectrums(torch.from_numpy(a), torch.from_numpy(b), conj).numpy()
        np.testing.assert_allclose(got, np.asarray(J.div_spectrums(jnp.asarray(a), jnp.asarray(b),
                                                                   conj)), rtol=1e-5)
        np.testing.assert_array_equal(P.div_spectrums(a, b, conj), J.div_spectrums(a, b, conj))


def test_errors_are_the_references():
    a = torch.zeros(3, 4, dtype=torch.uint8)
    for call in (lambda M, x: M.copy_make_border(x, -1, 0, 0, 0),
                 lambda M, x: M.copy_make_border(x, 1, 1, 1, 1, "mirror"),
                 lambda M, x: M.compare(x, x, "lte"), lambda M, x: M.reduce_mat(x, 2),
                 lambda M, x: M.reduce_mat(x, 0, "median"),
                 lambda M, x: M.mix_channels([x], [1], [0])):
        with pytest.raises(ValueError):
            call(P, a)
        with pytest.raises(ValueError):
            call(J, jnp.asarray(a.numpy()))
