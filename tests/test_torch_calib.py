"""The port's engine calibration (models/cns/calib.py) on the CPU: the
cache key comes from torch, the CPU picks the native engine without a
probe, NPT_CNS_ENGINE wins, a cached choice is read back (from the file
and in process), and an error of the device probe raises.  The probe's
measurement itself needs the card (tests/test_torch_gpu.py)."""
import json

import pytest
import torch

from nextpolish_tpu.models.cns import calib as jcalib
from nextpolish_tpu_torch.models.cns import calib
from nextpolish_tpu_torch.models.cns import device_dp as tdd
from nextpolish_tpu_torch.models.cns import window

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def fake_card(monkeypatch, tmp_path):
    """A card as far as the cache key can tell, a private cache file, an
    empty in-process cache and no override."""
    monkeypatch.setattr(calib, "resolve_device",
                        lambda device=None: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: CARD)
    monkeypatch.setenv("NPT_CNS_CALIB", str(tmp_path / "calib.json"))
    monkeypatch.delenv("NPT_CNS_ENGINE", raising=False)
    monkeypatch.setattr(calib, "_CHOSEN", {})
    return tmp_path / "calib.json"


def _no_probe(*a, **k):
    raise AssertionError("the probe ran")


def test_cache_key_comes_from_torch(fake_card):
    assert calib._cache_key("ont") == f"v{jcalib.CALIB_VERSION}/cuda/{CARD}/ont"
    assert calib.CALIB_VERSION == jcalib.CALIB_VERSION
    assert (calib.PROBE_LEN, calib.PROBE_COV) == (jcalib.PROBE_LEN,
                                                  jcalib.PROBE_COV)


def test_cpu_runs_native_without_a_probe(monkeypatch):
    monkeypatch.delenv("NPT_CNS_ENGINE", raising=False)
    monkeypatch.setattr(calib, "measure_engines", _no_probe)
    monkeypatch.setattr(calib, "choose_engine", _no_probe)
    assert window.default_engine("cpu") == "native"
    monkeypatch.setenv("NPT_CNS_ENGINE", "device")
    assert window.default_engine("cpu") == "device"


def test_cached_choice_is_read_back(fake_card, monkeypatch):
    key = calib._cache_key("ont")
    fake_card.write_text(json.dumps({key: {"engine": "native"}}))
    monkeypatch.setattr(calib, "measure_engines", _no_probe)
    assert calib.choose_engine("ont") == "native"
    fake_card.write_text(json.dumps({key: {"engine": "device"}}))
    assert calib.choose_engine("ont") == "native"  # in-process cache first


def test_measured_choice_is_cached(fake_card, monkeypatch):
    monkeypatch.setattr(calib, "measure_engines", lambda rt, device=None: {
        "device": 2.5e6, "native": 1.0e6})
    assert calib.choose_engine("ont") == "device"
    rec = json.loads(fake_card.read_text())[calib._cache_key("ont")]
    assert rec == {"engine": "device", "device_bases_per_s": 2.5e6,
                   "native_bases_per_s": 1.0e6}
    monkeypatch.setattr(calib, "_CHOSEN", {})
    monkeypatch.setattr(calib, "measure_engines", _no_probe)
    assert calib.choose_engine("ont") == "device"  # from the file


def test_device_probe_error_raises(monkeypatch):
    """JAX scores a failing device probe 0 and picks native; the port
    raises."""
    def broken(*a, **k):
        raise RuntimeError("level_chain kernel launch failed")

    monkeypatch.setattr(tdd, "_run_batch", broken)
    with pytest.raises(RuntimeError, match="level_chain"):
        calib.measure_engines("ont", "cpu")
