"""bench.py's device table: published peaks per ``device_kind``."""
import importlib.util
import os
import types

import pytest

_spec = importlib.util.spec_from_file_location(
    "bench", os.path.join(os.path.dirname(__file__), "..", "bench.py"))
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)


def _dev(platform, kind):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_h100_peak_is_the_data_sheet_rate():
    assert bench._hbm_peak(_dev("gpu", "NVIDIA H100 80GB HBM3")) == 3350.0


def test_unknown_gpu_kind_raises():
    with pytest.raises(KeyError, match="no published bandwidth"):
        bench._hbm_peak(_dev("gpu", "NVIDIA Imaginary 1"))


def test_cpu_has_no_device_peak():
    assert bench._hbm_peak(_dev("cpu", "cpu")) is None
