"""The multi-session encoder of the port: TorchMultiSessionEncoder against
JAX's MultiSessionEncoder (one virtual CPU device per session) element for
element, in both conversion modes and for the IDR, P and mixed ticks; the
batched device core and the batched ME/MC plain version against the solo
port functions session by session; the per-QP table against the
Python-int quantiser helpers at every QP."""

from __future__ import annotations

import functools

import numpy as np
import pytest
import torch

import jax

from selkies_tpu.models.h264 import numpy_ref as NR
from selkies_tpu.parallel import sessions as JS
from selkies_tpu_torch.models.h264 import encoder_core as TC
from selkies_tpu_torch.models.h264 import me_mc
from selkies_tpu_torch.ops.colorspace import bgrx_to_i420
from selkies_tpu_torch.parallel import sessions as TS
from selkies_tpu_torch.parallel.sessions import TorchMultiSessionEncoder

N, W, H = 4, 48, 48
QPS = np.array([20, 26, 30, 40], np.int32)
_ENV = ("SELKIES_FRONTEND_WORKERS", "SELKIES_PARALLEL_FRONTEND", "SELKIES_DAMAGE_FULL_SCAN")


@pytest.fixture(autouse=True)
def _pin_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)
    # one torch intra-op thread (many small CPU ops; xdist workers share cores)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _frames(seed: int, n: int = N, h: int = H, w: int = W):
    """Per-session BGRx frames of a tick: each session its own content,
    later ticks moved by a session-dependent shift (real motion vectors)."""
    rng = np.random.default_rng(seed)
    base = np.kron(rng.integers(0, 256, (n, h // 8 + 2, w // 8 + 2, 4), np.uint8),
                   np.ones((1, 8, 8, 1), np.uint8))
    base = np.clip(base.astype(np.int16) + rng.integers(-9, 10, base.shape), 0, 255)
    return np.stack([base[i, 3 + i:3 + i + h, 5 - i:5 - i + w] for i in range(n)]).astype(
        np.uint8)


def _tick_frames(t: int):
    """Tick t of the trace: the seed-1 content scrolled by (t, 2t) with a
    new block each tick."""
    f = np.roll(_frames(1), (t, 2 * t), (1, 2)).copy()
    f[:, 8 * t % H:8 * t % H + 8, :8] = _frames(100 + t)[:, :8, :8]
    return f


# (method, idrs) per tick; the first tick has no reference
STEPS = [("idr", None), ("p", None), ("mixed", (True, False, False, True)),
         ("mixed", (False,) * N), ("mixed", (True,) * N), ("mixed", (False, True, False, False))]


def _inputs(host_convert: bool, t: int):
    f = _tick_frames(t)
    return TS._host_planes(f) if host_convert else f


def _run(enc, host_convert: bool):
    outs = []
    for t, (method, idrs) in enumerate(STEPS):
        qps = np.roll(QPS, t)
        x = _inputs(host_convert, t)
        if method == "mixed":
            out = enc.encode_mixed(x, qps, np.array(idrs))
        else:
            out = getattr(enc, f"encode_{method}")(x, qps)
        host = {k: np.asarray(v) for k, v in out.items()}
        host.update({f"ref{i}": np.asarray(r) for i, r in enumerate(enc._ref)})
        outs.append(host)
    return outs


@functools.lru_cache(maxsize=None)
def jax_run(host_convert: bool):
    enc = JS.MultiSessionEncoder(N, W, H, devices=jax.devices()[:N], host_convert=host_convert)
    return _run(enc, host_convert)


@functools.lru_cache(maxsize=None)
def port_run(host_convert: bool):
    return _run(TorchMultiSessionEncoder(N, W, H, device="cpu", host_convert=host_convert),
                host_convert)


@pytest.mark.parametrize("tick", range(len(STEPS)),
                         ids=[f"{m}-{''.join('I' if x else 'P' for x in i or ())}" for m, i in STEPS])
@pytest.mark.parametrize("host_convert", [True, False], ids=["host", "device"])
def test_encoder_matches_jax(host_convert, tick):
    """Every output field and the kept reference planes equal JAX's."""
    got, want = port_run(host_convert)[tick], jax_run(host_convert)[tick]
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    method, idrs = STEPS[tick]
    if method == "p" or (method == "mixed" and not all(idrs)):  # P sessions found motion
        assert np.abs(got["mvs"]).sum() > 0


def test_mixed_tick_fillers_are_zero():
    got = port_run(True)[2]
    idrs = np.array(STEPS[2][1])
    assert not got["mvs"][idrs].any() and not got["skip"][idrs].any()
    assert not got["luma_dc"][~idrs].any() and not got["luma_mode"][~idrs].any()
    assert got["luma_mode"][idrs].any()


# -- the batched core against the solo port functions ---------------------


def _planes(seed: int, n: int, h: int, w: int):
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    return (t(rng.integers(0, 256, (n, h, w), np.uint8)),
            t(rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)),
            t(rng.integers(0, 256, (n, h // 2, w // 2), np.uint8)))


QP_SETS = [(0, 11, 26, 51), (5, 12, 17, 40), (28, 28, 28, 28)]


@pytest.mark.parametrize("qps", QP_SETS, ids=["-".join(map(str, q)) for q in QP_SETS])
def test_batched_intra_matches_solo(qps):
    y, u, v = _planes(3, len(qps), 48, 64)
    out = TC.encode_frame_planes_batch(y, u, v, torch.tensor(qps, dtype=torch.int32))
    for i, q in enumerate(qps):
        solo = TC.encode_frame_planes(y[i], u[i], v[i], q)
        for k in solo:
            assert torch.equal(out[k][i], solo[k]), (k, i)


@pytest.mark.parametrize("qps", QP_SETS, ids=["-".join(map(str, q)) for q in QP_SETS])
def test_batched_p_matches_solo(qps):
    n = len(qps)
    y, u, v = _planes(4, n, 64, 48)
    shifts = [(3, -5), (0, 0), (-7, 9), (12, 2)][:n]
    ry = torch.stack([torch.roll(y[i], s, (0, 1)) for i, s in enumerate(shifts)])
    ru, rv = torch.roll(u, 1, 1), torch.roll(v, -1, 2)
    out = TC.encode_frame_p_planes_batch(y, u, v, ry, ru, rv, torch.tensor(qps, dtype=torch.int32))
    for i, q in enumerate(qps):
        solo = TC.encode_frame_p_planes(y[i], u[i], v[i], ry[i], ru[i], rv[i], q)
        for k in solo:
            assert torch.equal(out[k][i], solo[k]), (k, i)


def test_batched_coarse_votes_match_solo():
    y, _, _ = _planes(5, 3, 64, 96)
    ref = torch.stack([torch.roll(y[i], (4 * i, -4 * i), (0, 1)) for i in range(3)])
    cands = TC.coarse_vote_candidates(y, ref)
    assert cands.shape == (3, TC.TOPK, 2)
    for i in range(3):
        assert torch.equal(cands[i], TC.coarse_vote_candidates(y[i], ref[i]))
        assert torch.equal(TC._refine_cands(cands)[i], TC._refine_cands(cands[i]))


def test_me_mc_batch_plain_matches_solo():
    y, u, v = _planes(6, 3, 48, 64)
    ref = torch.stack([torch.roll(y[i], (2 * i, -3 * i), (0, 1)) for i in range(3)])
    pads = [TC.edge_pad(p, TC.MV_PAD) for p in (ref, u, v)]
    assert pads[0].shape == (3, 48 + 80, 64 + 80)
    cands = TC._refine_cands(TC.coarse_vote_candidates(y.to(torch.int32), ref))
    cur = y.to(torch.int32)
    got = me_mc.me_mc_batch_plain(cands, cur, *pads)
    assert [tuple(g.shape) for g in got] == [(3, 3, 4, 2), (3, 48, 64), (3, 24, 32), (3, 24, 32)]
    for i in range(3):
        solo = me_mc.me_mc_plain(cands[i], cur[i], *(p[i] for p in pads))
        for g, s in zip(got, solo):
            assert torch.equal(g[i], s)
    # the wrapper takes the plain version for CPU tensors
    for g, s in zip(me_mc.me_mc_batch(cands, cur, *pads), got):
        assert torch.equal(g, s)


@pytest.mark.parametrize("bad", ["cands_2d", "sessions_differ", "plane_shape"])
def test_me_mc_batch_rejects_bad_shapes(bad):
    y, u, v = _planes(7, 2, 32, 32)
    pads = [TC.edge_pad(p, TC.MV_PAD) for p in (y, u, v)]
    cands = torch.zeros((2, 5, 2), dtype=torch.int32)
    cur = y.to(torch.int32)
    if bad == "cands_2d":
        cands = cands[0]
    elif bad == "sessions_differ":
        pads[1] = pads[1][:1]
    else:
        pads[0] = pads[0][:, 1:]
    with pytest.raises(ValueError):
        me_mc.me_mc_batch(cands, cur, *pads)


def test_bgrx_to_i420_over_a_session_axis():
    f = _frames(9, 3, 32, 48)
    ys, us, vs = bgrx_to_i420(torch.from_numpy(f))
    for i in range(3):
        y, u, v = bgrx_to_i420(torch.from_numpy(f[i]))
        assert torch.equal(ys[i], y) and torch.equal(us[i], u) and torch.equal(vs[i], v)


def test_qp_rows_equal_the_reference_at_every_qp():
    """Each quantiser helper on the gathered table rows (luma half at QP q,
    chroma half at chroma_qp(q)) equals the reference numpy_ref, for all
    52 QPs, and a Python-int QP (its one-row view) does too."""
    rng = np.random.default_rng(12)
    qps = torch.arange(52, dtype=torch.int32)
    rows = TC._QPRows.gather(qps)
    c = rng.integers(-2000, 2000, (52, 3, 4, 4)).astype(np.int32)
    lv = rng.integers(-40, 40, (52, 3, 4, 4)).astype(np.int32)
    dc2 = rng.integers(-3000, 3000, (52, 3, 2, 2)).astype(np.int32)
    helpers = {
        "quant4_i": (lambda x, q: TC.quant4(x, q, True), lambda x, q: NR.quant4(x, q, True), c),
        "quant4_p": (lambda x, q: TC.quant4(x, q, False), lambda x, q: NR.quant4(x, q, False), c),
        "dequant4": (TC.dequant4, NR.dequant4, lv),
        "quant_luma_dc": (TC.quant_luma_dc, NR.quant_luma_dc, c[:, 0]),
        "dequant_luma_dc": (TC.dequant_luma_dc, NR.dequant_luma_dc, lv[:, 0]),
    }
    chroma = {
        "quant_chroma_dc_i": (lambda x, q: TC.quant_chroma_dc(x, q, True),
                              lambda x, q: NR.quant_chroma_dc(x, q, True), dc2),
        "quant_chroma_dc_p": (lambda x, q: TC.quant_chroma_dc(x, q, False),
                              lambda x, q: NR.quant_chroma_dc(x, q, False), dc2),
        "dequant_chroma_dc": (TC.dequant_chroma_dc, NR.dequant_chroma_dc, dc2 // 50),
    }
    for table, qrows in ((helpers, rows), (chroma, rows.chroma())):
        for name, (port, ref, x) in table.items():
            got = port(torch.from_numpy(x), qrows).numpy()
            for q in range(52):
                qq = q if table is helpers else int(TC._CHROMA_QP[q])
                want = ref(x[q], qq)
                np.testing.assert_array_equal(got[q], want, err_msg=f"{name} rows {q}")
                np.testing.assert_array_equal(port(torch.from_numpy(x[q]), qq).numpy(), want,
                                              err_msg=f"{name} int {qq}")


# -- geometry and API -----------------------------------------------------


@pytest.mark.parametrize("w,h", [(1920, 1080), (50, 48), (48, 40)])
def test_unaligned_geometry_raises_as_jax(w, h):
    with pytest.raises(ValueError, match="MB-aligned"):
        JS.MultiSessionEncoder(1, w, h, devices=jax.devices()[:1])
    with pytest.raises(ValueError, match="MB-aligned"):
        TorchMultiSessionEncoder(1, w, h, device="cpu")


def test_p_before_idr_and_bad_batches_raise():
    enc = TorchMultiSessionEncoder(2, 32, 32, device="cpu")
    planes = TS._host_planes(_frames(2, 2, 32, 32))
    with pytest.raises(RuntimeError, match="encode_idr must run first"):
        enc.encode_p(planes, [28, 28])
    with pytest.raises(RuntimeError, match="encode_idr must run first"):
        enc.encode_mixed(planes, [28, 28], [False, True])
    with pytest.raises(ValueError, match="plane batch"):
        enc.encode_idr(tuple(p[:1] for p in planes), [28])
    with pytest.raises(ValueError, match="qp batch"):
        enc.encode_idr(planes, [28, 28, 28])
    enc.encode_idr(planes, [28, 30])
    with pytest.raises(ValueError, match="idrs"):
        enc.encode_mixed(planes, [28, 30], [True])


def test_device_none_means_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchMultiSessionEncoder(2, 32, 32)


def test_dryrun_on_cpu():
    TS.dryrun(3, device="cpu")
