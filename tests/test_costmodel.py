"""Cost-model constants: file plumbing + chooser sensitivity.

The chooser's pricing constants are data (ops/costmodel.py) resolved
from an env path / cache file with the shipped calibration as fallback;
a perturbed constants file must actually change the chooser's pick, and
a file calibrated on another device kind must not apply."""

import json

import numpy as np
import pytest

from pattern_matching.ops.costmodel import (
    DEFAULT_PATH,
    ENV_VAR,
    CostConstants,
    get_cost_constants,
)


def _pats(n=400, seed=11):
    rng = np.random.RandomState(seed)
    return [
        bytes(rng.randint(0, 256, size=12).astype(np.uint8))
        for _ in range(n)
    ]


def test_roundtrip_and_resolution(tmp_path, monkeypatch):
    cc = CostConstants(
        probe_ns_per_unit=0.5, refine_ns_per_slot=9.0,
        refine_fixed_ns_per_byte=0.25, verify_ns_per_cand=123.0,
        source="test",
    )
    p = tmp_path / "cc.json"
    cc.save(str(p))
    assert CostConstants.load(str(p)) == cc
    monkeypatch.setenv(ENV_VAR, str(p))
    assert get_cost_constants() == cc
    # a missing env path falls back to defaults
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "nope.json"))
    assert get_cost_constants().source == CostConstants().source


def test_broken_file_falls_back_loudly(tmp_path, monkeypatch, capsys):
    p = tmp_path / "cc.json"
    p.write_text(json.dumps({"probe_ns_per_unit": -1.0}))
    monkeypatch.setenv(ENV_VAR, str(p))
    cc = get_cost_constants()
    assert cc.source == CostConstants().source
    assert "WARNING" in capsys.readouterr().err
    p.write_text(json.dumps({"not_a_field": 1.0}))
    assert get_cost_constants().source == CostConstants().source


def test_other_device_calibration_refused_loudly(tmp_path, monkeypatch,
                                                capsys):
    from pattern_matching.ops.costmodel import calibrated_device, device_label

    here = CostConstants(probe_ns_per_unit=0.25,
                         source=f"calibrated:{device_label()}:350.00 W")
    p = tmp_path / "cc.json"
    here.save(str(p))
    monkeypatch.setenv(ENV_VAR, str(p))
    assert get_cost_constants() == here  # same device kind: used
    other = CostConstants(probe_ns_per_unit=0.25,
                          source="calibrated:gpu:Some Other Card:700.00 W")
    assert calibrated_device(other.source) == "gpu:Some Other Card"
    other.save(str(p))
    assert get_cost_constants() == CostConstants()
    assert "Some Other Card" in capsys.readouterr().err


def test_perturbed_constants_change_pick(tmp_path, monkeypatch):
    from pattern_matching.ops.bloom import BloomFilterTable

    monkeypatch.delenv(ENV_VAR, raising=False)
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "absent.json"))
    pats = _pats()
    cfg0 = BloomFilterTable.build(pats).cfg

    # make the probe astronomically expensive relative to verify: the
    # refined objective then minimizes probe cost alone and the pick
    # must move to a smaller/cheaper filter config
    CostConstants(
        probe_ns_per_unit=1e6,
        refine_ns_per_slot=1e-6,
        refine_fixed_ns_per_byte=1e-9,
        verify_ns_per_cand=1e-6,
        source="perturbed",
    ).save(str(tmp_path / "cc.json"))
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "cc.json"))
    cfg1 = BloomFilterTable.build(pats).cfg
    assert cfg1 != cfg0, (cfg0, cfg1)


def test_ushort_overrides_apply(tmp_path, monkeypatch):
    # a 2048-alphabet build prices
    # with ushort-calibrated constants when the cache file has them,
    # while byte builds keep the byte constants
    from pattern_matching.ops.bloom import BloomFilterTable

    cc = CostConstants(
        probe_ns_per_unit_u2048=123.0, verify_ns_per_cand_u2048=9.0,
        source="test-ushort",
    )
    p = tmp_path / "cc.json"
    cc.save(str(p))
    monkeypatch.setenv(ENV_VAR, str(p))
    got = get_cost_constants(2048)
    assert got.probe_ns_per_unit == 123.0
    assert got.verify_ns_per_cand == 9.0
    assert get_cost_constants(256).probe_ns_per_unit == cc.probe_ns_per_unit
    # a pre-round-5 cache file (no ushort keys) still loads and falls
    # back to the byte constants for the 2048 alphabet
    (tmp_path / "old.json").write_text(json.dumps({
        "probe_ns_per_unit": 0.5, "refine_ns_per_slot": 9.0,
        "refine_fixed_ns_per_byte": 0.25, "verify_ns_per_cand": 123.0,
        "source": "old",
    }))
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "old.json"))
    assert get_cost_constants(2048).probe_ns_per_unit == 0.5

    # chooser level: an absurd ushort probe price moves the 2048-alphabet
    # pick to a cheaper-probe config; the byte pick is untouched
    rng = np.random.RandomState(3)
    upats = [tuple(int(x) for x in rng.randint(0, 2048, size=8))
             for _ in range(300)]
    bpats = _pats()
    monkeypatch.setenv(ENV_VAR, str(tmp_path / "absent.json"))
    ucfg0 = BloomFilterTable.build(upats, alphabet_size=2048).cfg
    bcfg0 = BloomFilterTable.build(bpats).cfg
    CostConstants(
        probe_ns_per_unit_u2048=1e6, verify_ns_per_cand_u2048=1e-6,
        source="perturbed-ushort",
    ).save(str(p))
    monkeypatch.setenv(ENV_VAR, str(p))
    assert BloomFilterTable.build(upats, alphabet_size=2048).cfg != ucfg0
    assert BloomFilterTable.build(bpats).cfg == bcfg0


def test_default_path_is_user_cache():
    assert DEFAULT_PATH.endswith("cost_constants.json")
    assert ".cache" in DEFAULT_PATH
