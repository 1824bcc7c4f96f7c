"""The check of multi-slice access units: the reference's band slices, the
tile-grid entry and the faults that reach it.

On the CPU: at one band the reference's ``Coder`` gives the bytes it gave
before it knew of bands; at three it equals the
port's ``TorchBandedH264Encoder`` AU for AU, over bands and over a tile
grid; the check depends on the slicing and on the precision; and a run of a
sliced configuration reads correct, and not correct with each fault planted
or with the control in the program's place. On a card (``gpu``): the same
for one 4K desktop carved as the 3x2 grid, with the figures that size a
cell of it.
"""

from __future__ import annotations

import hashlib
import json
import shutil
import statistics
import time
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
DOC = json.loads((ROOT / "BENCHMARK.json").read_text())


def _screens(mix, *args):
    from yardstick import traffic
    from yardstick.spec import Spec

    params = traffic.load(BENCH / "traffic" / f"{mix}.json")
    return Spec(ROOT).pattern(params["pattern"])(params, *args)


def _plan(entry: str):
    from yardstick.spec import _module

    return _module(BENCH / "entries" / f"{entry}.py", f"entry_plan_{entry}").plan


# -- (a) one band: today's coder and today's bytes -----------------------------

# sha256 of the AUs (sorted by session, frame) that ``replay`` gave for these
# fixtures before the reference knew of bands
ONE_SLICE = {
    "sessions8": ({"width": 320, "height": 192, "qp": 28}, "pli", "session_service", 2, 10,
                  {(1, 4)}, "b1ff35a69124d7650a1e481c71d54d7717f995fe902bb18ec7225a259639e66f"),
    "solo": ({"width": 320, "height": 180, "qp": 28, "static_skip": True}, "typing", "solo_row", 1,
             10, {(0, 7)}, "c5dc135039a667eb8126ebaccded0ccc7f8adbe1ea46bee4c519fcfdb2f9c842"),
}


@pytest.mark.parametrize("shape", sorted(ONE_SLICE))
def test_one_band_is_todays_coder_with_todays_bytes(shape):
    from reference.replay import Coder, replay

    cfg, mix, entry, n, frames, requests, digest = ONE_SLICE[shape]
    plans = _plan(entry)(n, frames, requests)
    every = {(s, i) for s in range(n) for i in range(frames)}
    seed = 2**31 + 321
    for c in (cfg, dict(cfg, bands=1), dict(cfg, bands=1, cols=1)):
        assert Coder(c, n, "cpu").first_mb == [0]
    aus = replay(cfg, _screens(mix, n, cfg["height"], cfg["width"], seed), plans, every, "cpu")
    assert hashlib.sha256(b"".join(aus[k] for k in sorted(aus))).hexdigest() == digest
    enc, screens, ticked = Coder(dict(cfg, bands=1), n, "cpu"), _screens(
        mix, n, cfg["height"], cfg["width"], seed), {}
    for i in range(frames):
        ticked.update(enc.tick([(s, i, plans[s][i], screens.frame(s, i), screens.key(s, i))
                                for s in range(n)]))
    assert ticked == aus


# -- (b)-(d) the sliced reference against the port, the slicing, the precision --

W, H = 96, 144       # 6 x 9 MBs: 3 bands of 3 MB rows, 2 tile columns of 3 MBs


def _pan_frames(seed: int) -> list:
    """Busy frames whose motion crosses the band seams, the upper part of
    the screen panning one way and the lower part another (so the bands
    vote apart), an unchanged capture, and two frames after it."""
    rng = np.random.default_rng(seed)
    top, bottom = (rng.integers(0, 256, (H + 160, W + 160, 4), np.uint8) for _ in range(2))

    def frame(i):
        f = np.empty((H, W, 4), np.uint8)
        f[:70] = top[7 * i:7 * i + 70, 5 * i:5 * i + W]
        f[70:] = bottom[80 - 3 * i:80 - 3 * i + H - 70, 60 - 6 * i:60 - 6 * i + W]
        return f

    frames = [frame(i) for i in range(5)]
    return frames + [frames[-1].copy(), frame(6), frame(7), frame(8)]


IDRS = {0, 7}        # the first frame and a forced IDR after the unchanged capture


def _policy(n: int) -> list:
    from reference.replay import Frame

    out, pic, since = [], 0, 0
    for i in range(n):
        if i in IDRS:
            out.append(Frame(True, 0, pic))
            pic, since = pic ^ 1, 1
        else:
            out.append(Frame(False, since % 256))
            since += 1
    return out


def _reference(cfg: dict, frames: list, precision: str = "exact", single: bool = False) -> list:
    from reference.replay import Coder

    if single:
        cfg = {k: v for k, v in cfg.items() if k not in ("bands", "cols")}
    enc = Coder(cfg, 1, "cpu", precision)
    return [enc.tick([(0, i, fr, f, None)])[(0, i)]
            for i, (fr, f) in enumerate(zip(_policy(len(frames)), frames))]


def _cfg(bands: int, cols: int) -> dict:
    return {"width": W, "height": H, "qp": 28, "static_skip": True, "bands": bands, "cols": cols}


@pytest.mark.parametrize("bands,cols", [(3, 1), (3, 2)])
def test_the_sliced_reference_equals_the_banded_encoder(bands, cols):
    from reference.replay import Coder
    from selkies_tpu_torch.models.registry import create_encoder

    frames = _pan_frames(2**31 + 17)
    enc = create_encoder("tpuh264enc", width=W, height=H, qp=28, bands=bands, cols=cols,
                         device="cpu")
    try:
        assert (type(enc).__name__, enc.bands, enc.cols) == ("TorchBandedH264Encoder", bands, cols)
        aus = []
        for i, f in enumerate(frames):
            if i in IDRS and i:
                enc.force_keyframe()
            aus.append(enc.encode_frame(f))
    finally:
        enc.close()
    assert Coder(_cfg(bands, cols), 1, "cpu").first_mb == [0, 18, 36]
    ref = _reference(_cfg(bands, cols), frames)
    assert [len(a) for a in aus] == [len(r) for r in ref]
    assert [a == r for a, r in zip(aus, ref)] == [True] * len(frames)
    # the unchanged capture is three all-skip slices; every IDR has the SPS and PPS
    assert aus[5].count(b"\x00\x00\x00\x01") == bands
    assert all(aus[i].count(b"\x00\x00\x00\x01") == bands + 2 for i in IDRS)


def test_the_check_depends_on_the_slicing():
    frames = _pan_frames(2**31 + 18)
    sliced = _reference(_cfg(3, 1), frames)
    single = _reference(_cfg(3, 1), frames, single=True)
    assert all(a != b for a, b in zip(sliced, single))


def test_the_sliced_reference_in_bfloat16_differs():
    frames = _pan_frames(2**31 + 19)
    exact = _reference(_cfg(3, 2), frames)
    low = _reference(_cfg(3, 2), frames, "bf16")
    differ = [a != b for a, b in zip(exact, low)]
    assert differ[0] and differ[7]          # the IDRs
    assert sum(differ[1:5]) >= 3            # busy P frames
    assert not differ[5]                    # the all-skip picture has no levels


# -- (e) a run of a sliced configuration: correct, and caught when broken -------

GRID = {"name": "fixture_grid", "entry": "tile_grid_row", "row": "tpuh264enc", "width": 192,
        "height": 144, "fps": 60, "sessions": 1, "qp": 28, "static_skip": True, "bands": 3,
        "cols": 2, "reduced": []}


def _grid_spec(tmp: Path, cfg: dict, mix: str):
    from yardstick.spec import Spec

    (tmp / "cfg").mkdir(exist_ok=True)
    (tmp / "cfg" / "fixture_grid.json").write_text(json.dumps(cfg))
    doc = json.loads(json.dumps(DOC))
    doc["configs"].append({"name": "fixture_grid", "source": "https://example.org",
                           "file": "cfg/fixture_grid.json", "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "fixture.grid", "config": "fixture_grid", "traffic": mix,
                             "chips": 1, "why": "test"})
    return Spec(tmp, BENCH, doc=doc)


def _grid_cases() -> list:
    from faults import APPLIES

    return [None, "control"] + sorted(f for f, entries in APPLIES.items()
                                      if "tile_grid_row" in entries)


@pytest.mark.parametrize("case", _grid_cases(), ids=lambda c: c or "program")
def test_a_run_of_a_tile_grid_reads_correct_and_catches_each_fault(tmp_path, case):
    from control import ControlEntry
    from faults import FAULTS
    from yardstick.runner import run_cell

    spec = _grid_spec(tmp_path, GRID, "pli")
    kw = {}
    if case == "control":
        kw["make_entry"] = lambda cfg, dev: ControlEntry(spec.cell("fixture.grid"), dev)
    elif case is not None:
        kw["patch"] = FAULTS[case]
    res = run_cell(spec, "fixture.grid", 2**31 + 606, 3.0, False, "cpu", time.perf_counter(), **kw)
    if case is None:
        assert res["correct"], res["checks"]
        assert res["attempted"] > 0 and res["failed"] == 0
        assert res["timings"]["aus_compared"] >= 4   # a closed loop on a loaded CPU returns few frames
    else:
        assert not res["correct"]
        assert res["checks"]["aus_differing"]["value"] > 0


def test_the_entry_refuses_a_carve_the_encoder_changed(tmp_path):
    from yardstick.runner import run_cell

    # 9 MB rows do not split into 4 bands of 3 or more: the encoder would use 3
    spec = _grid_spec(tmp_path, dict(GRID, bands=4), "pli")
    with pytest.raises(ValueError, match="carved"):
        run_cell(spec, "fixture.grid", 1, 1.0, False, "cpu", time.perf_counter())
    from reference.replay import Coder

    with pytest.raises(ValueError, match="do not split"):
        Coder(dict(_cfg(3, 2), bands=4), 1, "cpu")


# -- on the card: one 4K desktop carved as the 3x2 grid --------------------------

FIXTURE_4K = {"name": "fixture_4k", "entry": "tile_grid_row", "row": "tpuh264enc",
              "width": 3840, "height": 2160, "fps": 60, "sessions": 1, "qp": 28,
              "static_skip": True, "bands": 3, "cols": 2, "reduced": []}


def _ref_ms(device) -> dict:
    """The sliced reference's milliseconds per 4K IDR and P frame on the card:
    reconstruction alone, and with the slices packed."""
    import torch

    from reference.replay import Coder, Frame

    screens = _screens("pli", 1, 2160, 3840, 2**31 + 1)
    out = {}
    for packed in (False, True):
        enc = Coder(FIXTURE_4K, 1, device)
        want = None if packed else set()
        times = {"idr": [], "p": []}
        for i in range(10):
            fr = Frame(True, 0, i // 4 % 2) if i % 4 == 0 else Frame(False, i % 4)
            torch.cuda.synchronize()
            t = time.perf_counter()
            enc.tick([(0, i, fr, screens.frame(0, i), None)], want)
            torch.cuda.synchronize()
            if i:   # the first call warms the card up
                times["idr" if fr.idr else "p"].append((time.perf_counter() - t) * 1e3)
        tag = "packed" if packed else "recon"
        out[f"idr_ms_{tag}"] = statistics.median(times["idr"])
        out[f"p_ms_{tag}"] = statistics.median(times["p"])
    return out


def _spec_4k(tmp_path: Path, keyframes: bool):
    """A copy of the benchmark with the 4K fixture's configuration and a cell
    ``fixture.bands4k`` on ``pli.json``'s game traffic, without its keyframe
    requests unless ``keyframes``."""
    from yardstick.spec import Spec

    bench = tmp_path / "bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (bench / "configs" / "fixture_4k.json").write_text(json.dumps(FIXTURE_4K))
    mix = {k: v for k, v in json.loads((BENCH / "traffic" / "pli.json").read_text()).items()
           if keyframes or k != "keyframe_every"}
    (bench / "traffic" / "fixture_motion.json").write_text(json.dumps(mix))
    doc = json.loads(json.dumps(DOC))
    doc["configs"].append({"name": "fixture_4k", "source": "https://example.org",
                           "file": "bench/configs/fixture_4k.json", "reduced": [], "why": "test"})
    doc["workloads"].append({"name": "fixture.bands4k", "config": "fixture_4k",
                             "traffic": "fixture_motion", "chips": 1, "why": "test"})
    return Spec(tmp_path, bench, doc=doc)


def _run_4k(monkeypatch, spec, seed: int, **kw) -> dict:
    """One 10 s run of ``fixture.bands4k`` on the card, with the figures that
    size a cell of it and the number of IDR AUs its check compared."""
    import torch

    from yardstick import runner

    idrs, replay = [], runner.replay

    def counted(cfg, screens, plans, want, *args, **kwargs):
        idrs.append(sum(1 for s, i in want if plans[s][i].idr))
        return replay(cfg, screens, plans, want, *args, **kwargs)

    monkeypatch.setattr(runner, "replay", counted)
    torch.cuda.reset_peak_memory_stats()
    res = runner.run_cell(spec, "fixture.bands4k", seed, 10.0, False, "cuda",
                          time.perf_counter(), **kw)
    t = res["timings"]
    return {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "fps": res["attempted"] / t["window_s"], **t, "idrs_compared": sum(idrs),
            "checks": {c: v["value"] for c, v in res["checks"].items()},
            "memory_peak_bytes": res["device"]["memory_peak_bytes"],
            "peak_with_check_bytes": torch.cuda.max_memory_allocated()}


@pytest.mark.gpu
def test_the_4k_tile_grid_reads_correct_on_the_card(tmp_path, monkeypatch):
    """A run of one 4K desktop on the 3x2 grid, with full motion and no
    keyframe requests, reads correct with 16 AUs or more compared; each
    fault and the bfloat16 control read not correct. Prints the figures
    that size a cell of it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from control import ControlEntry
    from faults import APPLIES, FAULTS

    spec = _spec_4k(tmp_path, keyframes=False)
    cell = spec.cell("fixture.bands4k")
    runs = {"program": {}, "control": {
        "make_entry": lambda cfg, dev: ControlEntry(cell, dev)}}
    runs.update({f: {"patch": FAULTS[f]} for f, e in APPLIES.items() if "tile_grid_row" in e})
    figures = {name: _run_4k(monkeypatch, spec, 2**31 + 4000 + k, **kw)
               for k, (name, kw) in enumerate(runs.items())}
    figures["reference"] = _ref_ms("cuda")
    figures["device"] = torch.cuda.get_device_name()
    print("FIGURES " + json.dumps(figures), flush=True)
    assert figures["program"]["correct"], figures["program"]
    assert figures["program"]["aus_compared"] >= 16 and figures["program"]["failed"] == 0
    for name in runs:
        if name != "program":
            assert not figures[name]["correct"], (name, figures[name])
            assert figures[name]["checks"]["aus_differing"] > 0


@pytest.mark.gpu
def test_the_4k_tile_grid_compares_window_idrs_on_the_card(tmp_path, monkeypatch):
    """The same fixture with ``pli.json``'s keyframe requests as they are:
    the check compares IDR access units of the window, the three band
    slices of the intra kernel's per-band DC chains, and reads correct."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fig = _run_4k(monkeypatch, _spec_4k(tmp_path, keyframes=True), 2**31 + 4100)
    fig["device"] = torch.cuda.get_device_name()
    print("FIGURES_IDR " + json.dumps(fig), flush=True)
    assert fig["correct"], fig
    assert fig["aus_compared"] >= 16 and fig["failed"] == 0
    assert fig["idrs_compared"] >= 1
