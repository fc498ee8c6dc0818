"""The port's core types (``rustcv_tpu_torch.core``, its own copies) against
the reference's ``rustcv_tpu.core``: the same names, pixel formats and
FourCC round trips, config defaults and policies, error hierarchy,
telemetry thresholds and clock regression. Exact comparisons."""

import dataclasses
import enum
import inspect

import pytest

import rustcv_tpu.core as ref
from rustcv_tpu_torch import core

def _plain(v):
    """An enum as its (class name, value); dataclasses and containers
    element by element; anything else as it is."""
    if isinstance(v, enum.Enum):
        return type(v).__name__, v.value
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return type(v).__name__, _plain(dataclasses.asdict(v))
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_plain(x) for x in v)
    return v


def test_exports_the_reference_names():
    assert set(core.__all__) == set(ref.__all__)
    for name in core.__all__:
        assert hasattr(core, name), name


def test_modules_are_the_ports_own():
    for name in core.__all__:
        mod = getattr(getattr(core, name), "__module__", "rustcv_tpu_torch.core")
        assert mod.startswith("rustcv_tpu_torch.core"), (name, mod)


@pytest.mark.parametrize("name", [m.name for m in ref.PixelFormat])
def test_pixel_format_members(name):
    port, want = core.PixelFormat[name], ref.PixelFormat[name]
    assert port.value == want.value
    assert (port.is_compressed, port.is_bayer) == (want.is_compressed, want.is_bayer)
    assert port.bpp_estimate() == want.bpp_estimate()
    try:
        size = want.buffer_size(64, 48)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e).split()[-1]):
            port.buffer_size(64, 48)
    else:
        assert port.buffer_size(64, 48) == size


def test_pixel_format_member_order():
    assert [m.name for m in core.PixelFormat] == [m.name for m in ref.PixelFormat]


@pytest.mark.parametrize("name", [m.name for m in ref.PixelFormat if m.name != "OTHER"])
def test_fourcc_round_trip(name):
    fcc = core.to_fourcc(core.PixelFormat[name])
    assert (fcc.value, str(fcc), repr(fcc)) == (lambda f: (f.value, str(f), repr(f)))(
        ref.to_fourcc(ref.PixelFormat[name]))
    fmt, back = core.from_fourcc(fcc)
    assert fmt is core.PixelFormat[name] and back == fcc


@pytest.mark.parametrize("code", ["YUYV", "GREY", "Y800", "MJPG", "Z16 ", "ABCD", 0x3231564E,
                                  0xFFFFFFFF, 0])
def test_from_fourcc_matches_the_reference(code):
    fmt, fcc = core.from_fourcc(code)
    want_fmt, want_fcc = ref.from_fourcc(code)
    assert (fmt.name, fcc.value, str(fcc)) == (want_fmt.name, want_fcc.value, str(want_fcc))
    if fmt is core.PixelFormat.OTHER:
        assert core.to_fourcc(fmt, fcc) == fcc
        with pytest.raises(ValueError):
            core.to_fourcc(fmt)


def test_fourcc_from_str_checks_length():
    for bad in ("YUY", "YUYV2"):
        with pytest.raises(ValueError):
            core.FourCC.from_str(bad)


@pytest.mark.parametrize("kw", [{}, {"fps": 30}, {"fps": 59}, {"fps": 60}, {"fps": 120},
                                {"pixel_format": "NV12", "fps": 10},
                                {"width": 1920, "height": 1080, "fps": 60}])
def test_simple_config_defaults_and_format_policy(kw):
    def build(pkg):
        args = dict(kw)
        if "pixel_format" in args:
            args["pixel_format"] = pkg.PixelFormat(args["pixel_format"])
        return pkg.SimpleConfig(**args)

    port, want = build(core), build(ref)
    assert _plain(port) == _plain(want)
    assert port.effective_format().name == want.effective_format().name


def test_simple_config_builders():
    def build(pkg):
        return (pkg.SimpleConfig().resolution(640, 360).with_fps(90)
                .with_pixel_format(pkg.PixelFormat.UYVY).with_buffer_count(7))

    assert _plain(build(core)) == _plain(build(ref))


def test_camera_config_defaults_and_builders():
    assert _plain(core.CameraConfig()) == _plain(ref.CameraConfig())

    def build(pkg):
        return (pkg.CameraConfig().resolution(1280, 720, pkg.Priority.HIGH).resolution(640, 480)
                .fps(60, pkg.Priority.REQUIRED).format(pkg.PixelFormat.YUYV, pkg.Priority.LOW)
                .with_buffer_count(4))

    assert _plain(build(core)) == _plain(build(ref))
    assert [(p.name, int(p)) for p in core.Priority] == [(p.name, int(p)) for p in ref.Priority]


def test_resolved_config_is_frozen():
    rc = core.ResolvedConfig(64, 48, 60, core.PixelFormat.YUYV, 5)
    assert _plain(rc) == _plain(ref.ResolvedConfig(64, 48, 60, ref.PixelFormat.YUYV, 5))
    with pytest.raises(dataclasses.FrozenInstanceError):
        rc.width = 1


def _errors(pkg):
    return {name: obj for name, obj in inspect.getmembers(pkg.errors, inspect.isclass)
            if issubclass(obj, Exception) and obj.__module__ == pkg.errors.__name__}


def test_error_names_and_hierarchy():
    import rustcv_tpu.core.errors  # noqa: F401
    import rustcv_tpu_torch.core.errors  # noqa: F401

    port, want = _errors(core), _errors(ref)
    assert set(port) == set(want)
    for name, cls in want.items():
        bases = [b.__name__ for b in cls.__mro__]
        assert [b.__name__ for b in port[name].__mro__] == bases, name
        assert issubclass(port[name], core.CameraError)


@pytest.mark.parametrize("kw", [{}, {"temperature_c": 70.0}, {"temperature_c": 80.0},
                                {"temperature_c": 90.0}, {"transmission_errors": 101},
                                {"temperature_c": 76.0, "transmission_errors": 500}])
def test_telemetry_health(kw):
    port, want = core.DeviceTelemetry(**kw).assess_health(), ref.DeviceTelemetry(**kw).assess_health()
    assert _plain(port) == _plain(want) and port.is_healthy == want.is_healthy


@pytest.mark.parametrize("n", [1, 4, 5, 12, 40])
def test_clock_synchronizer_regression(n):
    """The same corrected times, each counted from its own module's process
    start anchor (the two modules were imported at different moments)."""
    import rustcv_tpu.core.time_sync as ref_sync
    import rustcv_tpu_torch.core.time_sync as port_sync

    port, want = core.ClockSynchronizer(window_size=30), ref.ClockSynchronizer(window_size=30)
    for i in range(n):
        hw = 1_000_000_000 + i * 16_666_667 + (i % 3) * 1_000
        arrival = 100.0 + i * 0.0166667 + (i % 5) * 1e-5
        got = port.correct(hw, arrival) + port_sync._PROCESS_START
        assert got == pytest.approx(want.correct(hw, arrival) + ref_sync._PROCESS_START,
                                    rel=0, abs=1e-9)
    assert (port.estimated_slope, port.estimated_offset, port.drift_ppm) == (
        want.estimated_slope, want.estimated_offset, want.drift_ppm)


def test_frames_and_owned_copies():
    import numpy as np

    data = np.arange(64 * 48 * 2, dtype=np.uint8)
    ts = core.Timestamp(123_000, 1.5)
    frame = core.Frame(data, 64, 48, core.PixelFormat.YUYV, 7, ts)
    assert frame.timestamp_us == 123 and frame.metadata == core.FrameMetadata()
    owned = frame.to_owned()
    frame.invalidate()
    with pytest.raises(RuntimeError, match="requeued"):
        frame.data  # noqa: B018
    again = owned.as_frame()
    assert np.array_equal(again.data, data) and again.data is not data
    assert (again.sequence, again.timestamp, again.pixel_format) == (7, ts, core.PixelFormat.YUYV)
