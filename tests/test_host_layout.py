"""Native C++ marshaling library vs NumPy semantics (and the fallback)."""

import numpy as np
import pytest

from ocean_bgc.io import host_layout as hl


def test_native_builds_and_loads():
    assert hl.native_available(), "native library failed to build/load"


def test_level_major_roundtrip(rng):
    host = rng.standard_normal((137, 61))
    dev = hl.to_level_major(host)
    assert dev.shape == (61, 137)
    np.testing.assert_array_equal(dev, host.T)
    back = hl.from_level_major(dev)
    np.testing.assert_array_equal(back, host)


def test_tracer_block_roundtrip(rng):
    host = rng.standard_normal((53, 17, 30))
    dev = hl.pack_tracer_block(host)
    assert dev.shape == (17, 30, 53)
    np.testing.assert_array_equal(dev, host.transpose(1, 2, 0))
    back = hl.unpack_tracer_block(dev)
    np.testing.assert_array_equal(back, host)


def test_f32_widening(rng):
    host = rng.standard_normal((21, 9, 5)).astype(np.float32)
    dev = hl.pack_tracer_block(host)
    assert dev.dtype == np.float64
    np.testing.assert_array_equal(dev, host.transpose(1, 2, 0).astype(
        np.float64))


def test_scrub_nonfinite(rng):
    a = rng.standard_normal((40, 40))
    a[3, 7] = np.nan
    a[10, 2] = np.inf
    a[0, 0] = -np.inf
    n = hl.scrub_nonfinite(a, fill=-1.0)
    assert n == 3
    assert np.isfinite(a).all()
    assert a[3, 7] == -1.0 and a[0, 0] == -1.0


def test_numpy_fallback_matches(rng, monkeypatch):
    host = rng.standard_normal((31, 12, 8))
    want = hl.pack_tracer_block(host)
    monkeypatch.setattr(hl, "_load", lambda: None)
    got = hl.pack_tracer_block(host)
    np.testing.assert_array_equal(got, want)
