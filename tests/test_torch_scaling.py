"""qtpu_torch.scaling (the port of benchmarks/scaling_curve.py) and the
shards' streams of qtpu_torch.parallel.Mesh, on the CPU.

The curve's session at a small size: the n = 4096 mixed ladder, B = 16, 2
warm-up and 2 timed windows, ``max_inflight_windows=1`` (with more in
flight, Bob's rung depends on when stats land).  Exact: the same session
at D = 1, 2 and 4 CPU shards, and at D = 2 against the JAX reference's
session on a 2-device mesh of the conftest's forced CPU devices (keys,
ledgers, per-window metrics, psum'd ledgers).
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__
import qtpu.parallel as jpar
import qtpu.pipeline as jpipe
from qtpu_torch import _build, scaling
from qtpu_torch.parallel import make_mesh

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(blocks_per_window=16, max_inflight_windows=1)
WINDOWS, WARMUP = 2, 2


@pytest.fixture(scope="module")
def points():
    """run_point at D = 1, 2 and 4 CPU shards, made on first use."""
    made = {}

    def point(shards):
        if shards not in made:
            made[shards] = scaling.run_point(
                torch.device("cpu"), shards, WINDOWS, WARMUP,
                scaling.curve_config(**SMALL))
        return made[shards]

    return point


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_curve_session_equal_across_shards(points, shards):
    """Alice == Bob at every D (keys, ledgers), and every D == D = 1
    (keys, ledgers, per-window metrics); the row counts what ran."""
    row, alice, bob = points(shards)
    _, alice1, bob1 = points(1)
    key = bob1.final_key_bits()
    assert key.size > 0
    for party in (alice, bob):
        np.testing.assert_array_equal(party.final_key_bits(), key)
        assert party.ledger.as_dict() == bob1.ledger.as_dict()
    assert [m.as_dict() for m in bob.metrics] == \
        [m.as_dict() for m in bob1.metrics]
    assert (row["shards"], row["devices"], row["keys_equal"]) == \
        (shards, 1, True)
    assert row["windows"] >= WINDOWS and row["final_key_bits"] == key.size
    assert row["bp_layered_per_window"] == 0      # the plain decoder
    assert row["windows_per_s"] == pytest.approx(row["windows"]
                                                 / row["elapsed_s"])
    assert row["device"] == "cpu" and "cpu" in row["host"]
    assert len(bob.gled_by_window) == len(bob.metrics)


def test_curve_session_matches_reference_mesh(points):
    """D = 2 == the JAX session on a 2-device mesh over the same bits:
    keys, ledgers, per-window metrics and every window's psum'd ledger."""
    _, alice, bob = points(2)
    kw = dict(n=4096, qber_test_bits=1024, drain_windows=4, max_retries=0,
              **SMALL)
    a_bits, b_bits = scaling.curve_bits(scaling.curve_config(**SMALL),
                                        WINDOWS)
    ja, jb, jgled = __graft_entry__._run_session(
        jpipe.PipelineConfig(**kw), a_bits, b_bits,
        mesh=jpar.make_mesh("blocks", num=2))
    key = bob.final_key_bits()
    np.testing.assert_array_equal(jb.final_key_bits(), key)
    np.testing.assert_array_equal(ja.final_key_bits(), key)
    assert bob.ledger.as_dict() == jb.ledger.as_dict() == \
        ja.ledger.as_dict() == alice.ledger.as_dict()
    assert [m.as_dict() for m in bob.metrics] == \
        [m.as_dict() for m in jb.metrics]
    assert sorted(bob.gled_by_window) == sorted(jgled)
    for w, g in bob.gled_by_window.items():
        np.testing.assert_array_equal(g, np.asarray(jgled[w]))


def test_shard_devices():
    """Shard i on cuda:(i % cards); every CPU shard on the CPU."""
    cpu = torch.device("cpu")
    assert scaling.shard_devices(cpu, 4) == [cpu] * 4
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.cuda, "device_count", lambda: 3)
        assert scaling.shard_devices(torch.device("cuda", 0), 8) == [
            torch.device("cuda", i % 3) for i in range(8)]


def test_cpu_mesh_runs_shards_in_turn_without_streams():
    """A CPU mesh calls each shard in global order and makes no stream."""
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.run_shards(lambda g, dev: (g, dev.type)) == \
        [(g, "cpu") for g in range(4)]
    assert all(mesh.stream(g) is None for g in range(4))
    assert not mesh._streams


@pytest.mark.parametrize("argv", [
    ["0", "--device", "cpu"], ["x", "--device", "cpu"],
    ["--shards", "1,3", "--device", "cpu"], ["--shards", "0"],
    ["--shards", "a,b"], ["--device"]])
def test_main_refuses_bad_arguments(argv, capsys):
    """A WINDOWS below 1, shard counts that are not integers dividing the
    64 blocks, a --device without a value: a usage error (exit 2)."""
    with pytest.raises(SystemExit) as e:
        scaling.main(argv)
    assert e.value.code == 2
    assert "qtpu_torch.scaling" in capsys.readouterr().err


def test_main_cuda_without_card_exits(monkeypatch):
    """--device cuda (the default) without CUDA exits with entry_device's
    message, before any point runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(scaling, "run_point", None)
    for argv in (["--device", "cuda"], []):
        with pytest.raises(SystemExit) as e:
            scaling.main(argv)
        assert str(e.value) == (
            "qtpu_torch.scaling: --device cuda: CUDA is not available "
            "(pass --device cpu to run on the CPU)")


def test_main_writes_under_build_only(capsys):
    """One point on the CPU: a JSON line for it, one for the probes, the
    Markdown under build/qtpu_torch/, the repository's SCALING.md (the
    reference's output) untouched."""
    reference = ROOT / "SCALING.md"
    before = hashlib.sha256(reference.read_bytes()).hexdigest()
    assert scaling.OUT.parent == _build.BUILD_DIR
    assert _build.BUILD_DIR.resolve().is_relative_to(ROOT / "build")
    assert scaling.main(["1", "--device", "cpu", "--shards", "1"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    row, probes = json.loads(lines[0]), json.loads(lines[1])
    assert (row["shards"], row["keys_equal"]) == (1, True)
    assert probes["blocks"] == scaling.PROBE_BLOCKS
    assert [p["shards"] for p in probes["probes"]] == [1]
    assert probes["probes"][0]["psum_ms"] > 0
    assert lines[2] == f"wrote {scaling.OUT}"
    md = scaling.OUT.read_text()
    assert f"| 1 | 1 | {row['windows_per_s']:.3f} | 1.00x |" in md
    assert f"Rung {probes['rung']} " in md
    assert hashlib.sha256(reference.read_bytes()).hexdigest() == before
