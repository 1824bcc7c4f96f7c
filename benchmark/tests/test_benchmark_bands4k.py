"""The cell ``bands4k.motion`` on the CPU: what the spec finds for it, its
mix, a run of its configuration at a small size, and its readers.

The configuration ``grid3x2_4k`` is one 4K desktop carved as the 3x2 tile
grid; here a copy of it at 96x144 (the same carve, 3 band-rows of 3 MB
rows, 2 tile columns of 3 MBs) runs through the harness as a traced run
does, reads correct, and gives each reader of the program's spans a
number.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "bands4k.motion"
METRICS = [m["name"] for m in DOC["per_layer"] if CELL in m["workloads"]]
HOST_SPANS = ["dispatch_ms.bands4k", "convert_ms.bands4k", "gather_ms.bands4k"]


def _spec():
    from yardstick.spec import Spec

    return Spec(ROOT)


def test_the_spec_finds_the_cell():
    cell = _spec().cell(CELL)
    w = _spec().named("workloads", CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("grid3x2_4k", "motion", 1)
    assert cell.config["entry"] == "tile_grid_row" and cell.entry.__name__ == "entry_tile_grid_row"
    assert {k: cell.config[k] for k in ("row", "width", "height", "bands", "cols", "qp")} == {
        "row": "tpuh264enc", "width": 3840, "height": 2160, "bands": 3, "cols": 2, "qp": 28}
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "au_bytes"}
    assert sorted(m["name"] for m, _ in cell.per_layer) == sorted(METRICS)
    assert len(METRICS) == 7


def test_the_mix_is_pli_without_keyframe_requests():
    from yardstick import traffic

    pli = traffic.load(BENCH / "traffic" / "pli.json")
    motion = traffic.load(BENCH / "traffic" / "motion.json")
    assert pli.pop("keyframe_every") == 30
    assert motion == pli
    screens = _spec().cell(CELL).screens(motion, 1, 144, 96, 2**31 + 1)
    assert screens.keyframe_every == 0 and screens.keyframes(240) == []


def _small_spec(tmp_path: Path):
    """BENCHMARK.json with ``grid3x2_4k`` at 96x144, nothing else changed."""
    from yardstick.spec import Spec

    entry = _spec().named("configs", "grid3x2_4k")
    cfg = json.loads((ROOT / entry["file"]).read_text())
    small = dict(cfg, width=96, height=144)
    (tmp_path / "grid3x2_small.json").write_text(json.dumps(small))
    doc = json.loads(json.dumps(DOC))
    for c in doc["configs"]:
        if c["name"] == "grid3x2_4k":
            c["file"] = "grid3x2_small.json"
    return Spec(tmp_path, BENCH, doc=doc)


def test_a_small_copy_of_the_configuration_reads_correct_with_its_spans(tmp_path):
    from yardstick.runner import run_cell

    res = run_cell(_small_spec(tmp_path), CELL, 2**31 + 2323, 3.0, True, "cpu",
                   time.perf_counter())
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["timings"]["aus_compared"] >= 4   # a closed loop on a loaded CPU returns few frames
    got = res["metrics"]
    for name in HOST_SPANS + ["fps.bands4k"]:
        assert got[name]["value"] > 0, name
    # no card: no device span and no device trace
    assert set(got) == set(HOST_SPANS + ["fps.bands4k"])


def test_the_k1_roofline_counts_a_tiles_contract():
    from yardstick.roofline import bandwidth_share, k1_bytes

    reader = _spec().reader("k1_roofline.bands4k")
    cfg = _spec().cell(CELL).config
    assert reader.tile(cfg) == (720, 1920)
    act = SimpleNamespace(kernel=lambda needle: (6, 2e-3) if needle == "me_mc_kernel" else (0, 0))
    run = SimpleNamespace(activity=act, config=cfg)
    assert reader.read(run) == bandwidth_share(k1_bytes(720, 1920), 2e-3)
    assert reader.read(SimpleNamespace(activity=None, config=cfg)) is None


def _tracer(spans, device=()):
    from selkies_tpu_torch.monitoring.tracing import Tracer

    t = Tracer()
    t.enable()
    for name, ms in spans:
        t.record(name, 10.0, 10.0 + ms / 1e3)
    for ms in device:
        with t._lock:
            t._fold("gpu-step", ms / 1e3)
    return t


def _run(spans=(), device=()):
    tracer = _tracer(spans, device)
    return SimpleNamespace(entry=SimpleNamespace(tracer=lambda: tracer))


def test_the_span_readers():
    run = _run([("step-p", 40.0), ("step-p", 60.0), ("step-i", 900.0), ("convert", 12.0),
                ("row_gather", 30.0), ("row_gather", 50.0), ("band-row", 15.0)],
               device=[70.0, 90.0])
    read = {m: _spec().reader(m).read(run) for m in HOST_SPANS + ["gpu_step_ms.bands4k"]}
    assert read == pytest.approx({"dispatch_ms.bands4k": 50.0, "convert_ms.bands4k": 12.0,
                                  "gather_ms.bands4k": 40.0, "gpu_step_ms.bands4k": 80.0})


@pytest.mark.parametrize("metric", ["dispatch_ms.bands4k", "convert_ms.bands4k",
                                    "gpu_step_ms.bands4k"])
def test_a_program_without_the_dispatch_spans_reads_none(metric):
    """The tile grid before its dispatch had spans: only the completion's
    ``row_gather``, ``step``, ``fetch``, ``unpack`` and ``pack``."""
    run = _run([("row_gather", 30.0), ("step", 20.0), ("fetch", 1.0), ("unpack", 2.0),
                ("pack", 9.0)])
    assert _spec().reader(metric).read(run) is None
