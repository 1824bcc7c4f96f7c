"""Port parity for the host front end: FramePrep (convert, convert_tiles,
the fused scan with and without damage hints, with hashes), tile_hash_np
and TileCache against the JAX package's; the port's native build against
its own numpy versions. Exact equality throughout."""

from __future__ import annotations

import numpy as np
import pytest

from selkies_tpu.models import frameprep as JF
from selkies_tpu.models import tilecache as JT
from selkies_tpu_torch.models import frameprep as TF
from selkies_tpu_torch.models import tilecache as TT
from selkies_tpu_torch.utils import build

# 320x192: every tile cacheable (64-col tiles); 328x200: 16-col tiles and
# a partial bottom band, so edge tiles are not cacheable
GEOMS = [(320, 192), (328, 200)]
GID = [f"{w}x{h}" for w, h in GEOMS]


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for k in ("SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND",
              "SELKIES_DAMAGE_FULL_SCAN"):
        monkeypatch.delenv(k, raising=False)


def _pads(w, h):
    return (w + 15) // 16 * 16, (h + 15) // 16 * 16


def _frames(w, h, seed, n=5):
    """A wallpaper, then edits: a typing patch, a patch on the right and
    bottom edges, a 16-row scroll, and a repeat."""
    rng = np.random.default_rng(seed)
    f = np.kron(rng.integers(0, 255, (h // 8 + 1, w // 8 + 1, 4), np.uint8),
                np.ones((8, 8, 1), np.uint8))[:h, :w].copy()
    out = [f]
    g = f.copy()
    g[20:33, 30:90] = rng.integers(0, 255, (13, 60, 4), np.uint8)
    out.append(g)
    g = g.copy()
    g[h - 9:, w - 21:] = 3
    out.append(g)
    out.append(np.ascontiguousarray(np.roll(g, -16, 0)))
    out.append(out[-1].copy())
    return out[:n]


@pytest.mark.parametrize("geom", GEOMS, ids=GID)
def test_convert_matches_jax_and_plain(geom):
    w, h = geom
    pw, ph = _pads(w, h)
    frame = _frames(w, h, 1)[1]
    want = JF.FramePrep(w, h, pw, ph).convert(frame)
    got = TF.FramePrep(w, h, pw, ph).convert(frame)
    plain = TF._numpy_convert_pad(frame, ph, pw)
    for g, jw, p in zip(got, want, plain):
        np.testing.assert_array_equal(g, jw)
        np.testing.assert_array_equal(g, p)


@pytest.mark.parametrize("geom", [(1920, 1088), (48, 32)], ids=["1920x1088", "48x32"])
def test_device_conversion_equals_the_host_converter(geom):
    """ops.colorspace's plain conversion (what a CPU service runs, and what
    the card's kernel is held to) gives FramePrep.convert's planes on
    random frames and on the clip edges: the service's switch from host to
    device conversion keeps every byte."""
    import torch

    from selkies_tpu_torch.ops.colorspace import bgrx_to_i420

    w, h = geom
    rng = np.random.default_rng(7)
    frames = [rng.integers(0, 256, (h, w, 4), np.uint8) for _ in range(2)]
    for value in ((0, 0, 0, 0), (255, 255, 255, 255), (255, 0, 0, 0), (0, 255, 0, 0),
                  (0, 0, 255, 0)):
        frames.append(np.broadcast_to(np.array(value, np.uint8), (h, w, 4)).copy())
    prep = TF.FramePrep(w, h, w, h)
    for frame in frames:
        want = prep.convert(frame)
        got = bgrx_to_i420(torch.from_numpy(frame))
        for g, p in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), p)


@pytest.mark.parametrize("geom", GEOMS, ids=GID)
def test_convert_tiles_matches_jax_and_plain(geom):
    w, h = geom
    pw, ph = _pads(w, h)
    tw = TF.tile_width_for(w)
    assert tw == JF.tile_width_for(w)
    assert TF.delta_buckets_for(w, h) == JF.delta_buckets_for(w, h)
    frame = _frames(w, h, 2)[2]
    nb, nt = ph // 16, pw // tw
    idx = np.array([0, 1024 + 2, (nb - 1) * 1024 + nt - 1, 3 * 1024 + nt - 1,
                    (nb - 1) * 1024], np.int32)
    want = JF.FramePrep(w, h, pw, ph).convert_tiles(frame, idx, tw)
    got = TF.FramePrep(w, h, pw, ph).convert_tiles(frame, idx, tw)
    y, u, v = TF._numpy_convert_pad(frame, ph, pw)
    for i, d in enumerate(idx):
        b, t = divmod(int(d), 1024)
        np.testing.assert_array_equal(got[0][i], y[16 * b:16 * b + 16, tw * t:tw * (t + 1)])
        np.testing.assert_array_equal(got[1][i], u[8 * b:8 * b + 8, tw // 2 * t:tw // 2 * (t + 1)])
        np.testing.assert_array_equal(got[2][i], v[8 * b:8 * b + 8, tw // 2 * t:tw // 2 * (t + 1)])
    for g, jw in zip(got, want):
        np.testing.assert_array_equal(g, jw)


def _scan_all(prep, frames, tw, damage, plain=False):
    out = []
    for i, f in enumerate(frames):
        kw = {"plain": True} if plain else {}
        res = prep.scan(f, tw, damage=damage[i] if damage else None, want_hashes=True, **kw)
        if res is None:
            out.append(None)
            continue
        cach = np.zeros_like(res.tiles)
        cach[: prep.height // 16, : prep.width // tw] = True
        hashes = np.where(res.tiles & cach, res.hashes, 0)
        out.append((res.tiles.copy(), hashes, res.full_scan, prep._prev.copy()))
    return out


@pytest.mark.parametrize("damage", [False, True], ids=["full_scan", "damage"])
@pytest.mark.parametrize("geom", GEOMS, ids=GID)
def test_scan_matches_jax_and_plain(geom, damage):
    w, h = geom
    pw, ph = _pads(w, h)
    tw = TF.tile_width_for(w)
    frames = _frames(w, h, 3)
    # supersets of each frame's change (the scroll's is the whole frame);
    # the last frame's empty list means "nothing changed"
    hints = [None, [(30, 20, 60, 13)], [(w - 21, h - 9, 21, 9)], [(0, 0, w, h)], []] \
        if damage else None
    want = _scan_all(JF.FramePrep(w, h, pw, ph), frames, tw, hints)
    got = _scan_all(TF.FramePrep(w, h, pw, ph), frames, tw, hints)
    plain = _scan_all(TF.FramePrep(w, h, pw, ph), frames, tw, hints, plain=True)
    assert want[0] is None and got[0] is None and plain[0] is None
    for g, jw, p in zip(got[1:], want[1:], plain[1:]):
        for a, b, c in zip(g, jw, p):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert got[-1][0].sum() == 0


def test_parallel_scan_equals_serial(monkeypatch):
    """A tall frame splits the scan into band chunks on the shared pool;
    the result equals the serial scan and the JAX scan."""
    w, h = 96, 512
    monkeypatch.setenv("SELKIES_FRONTEND_WORKERS", "4")
    frames = _frames(w, h, 4, n=4)
    res = []
    for mod, serial in ((TF, False), (TF, True), (JF, False)):
        monkeypatch.setenv("SELKIES_PARALLEL_FRONTEND", "0" if serial else "1")
        res.append(_scan_all(mod.FramePrep(w, h, w, h), frames, 32, None))
    for got in res[1:]:
        for g, jw in zip(res[0][1:], got[1:]):
            for a, b in zip(g, jw):
                np.testing.assert_array_equal(a, b)


def test_damage_full_scan_ratchet(monkeypatch):
    monkeypatch.setenv("SELKIES_DAMAGE_FULL_SCAN", "2")
    w, h = 320, 192
    prep = TF.FramePrep(w, h, w, h)
    frames = _frames(w, h, 5)
    prep.scan(frames[0], 64)
    full = [prep.scan(f, 64, damage=[]).full_scan for f in frames[1:]]
    assert full == [False, True, False, True]


def test_tile_hash_matches_jax():
    rng = np.random.default_rng(6)
    tiles = rng.integers(0, 256, (7, 16 * 64 * 4), np.uint8)
    want = JT.tile_hash_np(tiles)
    np.testing.assert_array_equal(TT.tile_hash_np(tiles), want)
    np.testing.assert_array_equal(TT.tile_hash_numpy(tiles), want)


def _cache_state(c):
    return (dict(c._hash2slot), list(c._slot_hash), list(c._free), c._stamp.tolist(),
            c._clock, c._store.copy(), c.hits, c.misses, c.evictions)


@pytest.mark.parametrize("geom", GEOMS, ids=GID)
def test_tilecache_sequence_matches_jax(geom):
    """Seeded split/probe calls (over budget, with and without the scan's
    hashes, an eviction-forcing small pool) give equal outputs and state."""
    w, h = geom
    tw = TF.tile_width_for(w)
    nb, nt = (h + 15) // 16, (w + 15) // 16 * 16 // tw
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (h, w, 4), np.uint8)
    alt = rng.integers(0, 255, (h, w, 4), np.uint8)
    caches = (JT.TileCache(h, w, tw, 5), TT.TileCache(h, w, tw, 5))
    all_idx = np.array([b * 1024 + t for b in range(nb) for t in range(nt)], np.int32)
    for step in range(8):
        frame = base if step % 3 != 2 else alt
        idx = np.sort(rng.choice(all_idx[:9], size=5, replace=False))  # repeats hit
        # a same-call duplicate, and the last tile (an edge tile at 328x200)
        idx = np.concatenate([idx, idx[:1], all_idx[-1:]]).astype(np.int32)
        max_up = 2 if step == 4 else None
        outs = []
        for c, prep_mod in zip(caches, (JF, TF)):
            prep = prep_mod.FramePrep(w, h, (w + 15) // 16 * 16, (h + 15) // 16 * 16)
            prep.scan(np.zeros_like(frame), tw)
            hashes = prep.scan(frame, tw, want_hashes=True).hashes if step % 2 else None
            probe = c.probe(frame, idx, hashes=hashes)
            split = c.split(frame, idx, max_up=max_up, hashes=hashes)
            outs.append((probe, split, _cache_state(c)))
        (jp, js, jst), (tp, ts, tst) = outs
        assert tp == jp
        assert (ts is None) == (js is None)
        if js is not None:
            for a, b in zip(ts, js):
                np.testing.assert_array_equal(a, b)
        for a, b in zip(tst, jst):
            if isinstance(a, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b
    assert caches[1].hits > 0 and caches[1].evictions > 0


def test_frameprep_build_failure_raises(monkeypatch):
    """No quiet numpy fallback: a failed build raises from FramePrep."""
    def fail(*a, **k):
        raise RuntimeError("building libframeprep failed (1)")

    monkeypatch.setattr(TF, "_lib", None)
    monkeypatch.setattr(TF, "build_shared", fail)
    with pytest.raises(RuntimeError, match="libframeprep"):
        TF.FramePrep(320, 192, 320, 192)


def test_frameprep_library_is_built_in_build_dir():
    res = TF.build()
    assert res.path.parent == build.BUILD_DIR
    assert res.path.name.startswith("libframeprep-") and res.path.suffix == ".so"
