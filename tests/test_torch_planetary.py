"""The port's planetary session (``siril_tpu_torch/planetary``,
``registration/shift.py``, the MPP commands, ``rgbcomp -align``) against
the JAX package on the CPU, on the same seeded inputs, and against the
MPP golden.

Bounds, and why:
- ``quality_core``: 1e-5 relative, the same order (float32 sums in
  another order).
- ``blur_gauss``, ``_shift_core``: 1e-6 (float32, another FFT).
- ``_tm_ccoeff_normed``: bit-equal where the box is tiled (48 px, the
  default), 1e-6 below (the template's norm an ULP apart); the port runs
  the JAX package's float32 summation order.
- ``mlc_core`` on the same windows: the same integer shifts and
  successes (a tie and a border hit among them), sub-pixel 1e-3 px.
- ``phase_correlate``, ``register_shift_dft``, ``register_comet``: 1e-4
  px on frames with noise; ``template_match`` the same positions.  The
  whitened spectrum of a noiseless frame is float32 rounding noise at
  high frequencies, so there the packages' FFTs part (ROADMAP §3).
- The two SER decodes: each bit-equal to the JAX package's.
- MPP on one noisy SER: the same best frame and AP grid, global shifts
  within 1e-3 px; AP shifts within 1e-3 px on 95 % of the (frame, AP)
  solves and 1e-2 px on all (the sub-pixel fit magnifies the FFTs'
  rounding); AP quality 1e-4 relative, a differing frame pick a near
  tie; the image within 2e-4.
- The golden (``tests/golden/mpp_golden.npz``): ``TestMPPGolden``'s
  tolerances, the AP shifts on the APs whose reference box has structure
  (std > 0.02; the one near-background AP's solve is float32 noise in
  both packages).
- The commands: the same files and log lines within the bounds above.
"""

import re
import shutil

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.ndimage import shift as ndshift

import jax
import jax.numpy as jnp
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.core.sequence import Sequence as JSeq
from siril_tpu.io.fits_io import write_fits as jwrite_fits
from siril_tpu.io.ser import SER_MONO, SerWriter
from siril_tpu.planetary import mlc as jmlc
from siril_tpu.planetary import mpp as jmpp
from siril_tpu.planetary import quality as jq
from siril_tpu.registration import shift as jshift
from siril_tpu_torch.core.sequence import Sequence as TSeq
from siril_tpu_torch.planetary import mlc as tmlc
from siril_tpu_torch.planetary import mpp as tmpp
from siril_tpu_torch.planetary import quality as tq
from siril_tpu_torch.planetary import source as tsrc
from siril_tpu_torch.registration import shift as tshift
from tests import test_mpp_stages as jstages

torch.set_num_threads(1)

CPU = "cpu"
SIZE = 160
FRAMES = 8


@pytest.fixture(scope="module", autouse=True)
def _blur_cache_outside_a_trace():
    """The JAX package's blur caches its kernel at first use; made inside
    a jit trace, a later trace of another geometry leaks it.  Make it
    outside."""
    jmlc._blur_fn.cache_clear()
    jmlc.blur_gauss(jnp.zeros((1, 8, 8), jnp.float32), 7)


def _noisy_frames(seed=7, n=FRAMES, size=SIZE, shift=4.0):
    rng = np.random.default_rng(seed)
    scene = jstages._planet_scene(size, size, rng)
    out = []
    for _ in range(n):
        f = ndshift(scene, rng.uniform(-shift, shift, 2), order=3,
                    mode="nearest")
        f = gaussian_filter(f, rng.uniform(0.5, 1.5)) + \
            rng.normal(0, 0.01, f.shape)
        out.append(np.clip(f, 0, 1).astype(np.float32))
    return scene, np.stack(out)


def _write_ser(path, frames):
    w = SerWriter(str(path), frames.shape[2], frames.shape[1], SER_MONO, 16)
    for f in frames:
        w.write_frame(JImage(data=f[None]))
    w.close()


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    """One noisy SER through both packages' three MPP stages."""
    d = tmp_path_factory.mktemp("video")
    scene, frames = _noisy_frames()
    _write_ser(d / "planet.ser", frames)
    jseq, tseq = JSeq.from_ser(str(d / "planet.ser")), \
        TSeq.from_ser(str(d / "planet.ser"))
    js = jmpp.mpp_analyze(jseq, jmpp.MPPArgs())
    js = jmpp.mpp_compute_shifts(jseq, js, jmpp.MPPArgs())
    jimg = jmpp.mpp_stack(jseq, js, jmpp.MPPArgs())
    ts = tmpp.mpp_analyze(tseq, tmpp.MPPArgs(), CPU)
    ts = tmpp.mpp_compute_shifts(tseq, ts, tmpp.MPPArgs(), CPU)
    timg = tmpp.mpp_stack(tseq, ts, tmpp.MPPArgs(), CPU)
    return dict(dir=d, scene=scene, frames=frames, jseq=jseq, tseq=tseq,
                js=js, ts=ts, jimg=jimg, timg=timg)


def test_quality_core_vs_jax(video):
    frames = np.concatenate([video["frames"], np.stack(
        [gaussian_filter(video["scene"], s).astype(np.float32)
         for s in (0.5, 1.0, 2.0)])])
    want = np.asarray(jq.quality_batch(frames))
    got = tq.quality_batch(frames, device=CPU)
    assert np.abs(got / want - 1).max() <= 1e-5
    assert np.array_equal(np.argsort(got), np.argsort(want))


def test_blur_and_shift_core_vs_jax():
    rng = np.random.default_rng(3)
    x = rng.random((3, 40, 52)).astype(np.float32)
    got = tmlc.blur_gauss(torch.from_numpy(x), 7).numpy()
    assert np.abs(got - np.asarray(jmlc.blur_gauss(jnp.asarray(x)))
                  ).max() <= 1e-6
    sh = rng.uniform(-3, 3, (3, 2)).astype(np.float32)
    want = np.asarray(jax.jit(jmpp._shift_core)(jnp.asarray(x),
                                                 jnp.asarray(sh)))
    got = tmpp._shift_core(torch.from_numpy(x), torch.from_numpy(sh))
    assert np.abs(got.numpy() - want).max() <= 1e-6


@pytest.mark.parametrize("hw,h,tol", [(56, 48, 0.0), (34, 24, 1e-6)])
def test_tm_ccoeff_normed_vs_jax(hw, h, tol):
    rng = np.random.default_rng(hw)
    win = np.stack([gaussian_filter(rng.random((hw, hw)), 2) * 0.3 + 0.4
                    for _ in range(8)]).astype(np.float32)
    tp = np.stack([gaussian_filter(rng.random((h, h)), 2) * 0.3 + 0.4
                   for _ in range(8)]).astype(np.float32)
    # under jit, as the JAX package runs it (op by op, XLA rounds
    # otherwise)
    want = np.asarray(jax.jit(jmlc._tm_ccoeff_normed)(jnp.asarray(win),
                                                      jnp.asarray(tp)))
    got = tmlc._tm_ccoeff_normed(torch.from_numpy(win),
                                 torch.from_numpy(tp)).numpy()
    assert np.abs(got - want).max() <= tol


def test_mlc_core_vs_jax():
    """Shifted noisy boxes, a constant window (every correlation 0: a tie,
    the first offset taken, a border hit in phase 2) and a box moved past
    the search (a border hit in phase 1)."""
    rng = np.random.default_rng(1)
    S, E = 48, tmlc.mlc_window_extent(14)
    base = gaussian_filter(rng.random((300, 300)), 2).astype(np.float32)
    bigs, refs = [], []
    for k in range(24):
        d = rng.uniform(-9, 9, 2) if k < 22 else np.array([16.0, -3.0])
        img = ndshift(base, d, order=3) + rng.normal(0, 0.002, base.shape)
        bigs.append(img[100 - E:100 + S + E, 100 - E:100 + S + E])
        refs.append(base[100:100 + S, 100:100 + S])
    bigs[22] = np.full_like(bigs[22], 0.4)
    bigs = np.stack(bigs).astype(np.float32)
    refs = np.stack(refs).astype(np.float32)
    jdy, jdx, jok = jmlc.multilevel_correlation_batch(bigs, refs)
    tdy, tdx, tok = tmlc.multilevel_correlation_batch(bigs, refs,
                                                      device=CPU)
    assert np.array_equal(jok, tok) and not tok[22] and not tok[23]
    assert tok[:22].all()
    assert np.array_equal(np.round(jdy), np.round(tdy))
    assert np.array_equal(np.round(jdx), np.round(tdx))
    assert np.abs(tdy - jdy).max() <= 1e-3
    assert np.abs(tdx - jdx).max() <= 1e-3


def test_phase_correlate_and_template_match_vs_jax(video):
    frames = video["frames"]
    want = jshift.phase_correlate(frames[0], frames)
    got = tshift.phase_correlate(frames[0], frames, device=CPU)
    assert np.abs(got - want).max() <= 1e-4
    # blank frames: a correlation of zeros everywhere, the first maximum
    blank = np.zeros((2,) + frames.shape[1:], np.float32)
    got = tshift.phase_correlate(blank[0], blank, device=CPU)
    assert np.array_equal(got, jshift.phase_correlate(blank[0], blank))
    assert (got == 0).all()
    patch = frames[0, 60:92, 50:90]
    want = jshift.template_match(patch, frames)
    assert np.array_equal(tshift.template_match(patch, frames, CPU), want)
    zero = np.zeros_like(patch)            # every offset ties at 0
    assert np.array_equal(tshift.template_match(zero, frames, CPU),
                          jshift.template_match(zero, frames))
    assert (tshift.template_match(zero, frames, CPU) == 0).all()


def test_register_shift_dft_and_comet_vs_jax(tmp_path):
    _, frames = _noisy_frames(seed=11, n=5, size=96)
    for who in ("jax", "port"):
        (tmp_path / who).mkdir()
        for i, f in enumerate(frames):
            img = JImage(data=f[None])
            img.keywords.date_obs = f"2024-03-01T01:{10 * i:02d}:00"
            jwrite_fits(img, str(tmp_path / who / f"pl_{i + 1:05d}.fit"),
                        bitdepth=16)
    jseq = JSeq.scan("pl_", str(tmp_path / "jax"))
    tseq = TSeq.scan("pl_", str(tmp_path / "port"))
    jr = jshift.register_shift_dft(jseq)
    tr = tshift.register_shift_dft(tseq, device=CPU)
    assert np.abs(tr.H - jr.H).max() <= 1e-4
    assert np.array_equal(tr.valid, jr.valid)
    a = ((10.0, 20.0), "2024-03-01T01:00:00", (13.0, 16.0),
         "2024-03-01T02:00:00")
    jr = jshift.register_comet(jseq, *a)
    tr = tshift.register_comet(tseq, *a)
    assert np.abs(tr.H - jr.H).max() <= 1e-12


def test_ser_decodes_vs_jax(tmp_path):
    """The resident store's ``raw · float32(1/maxval)`` and the host
    read's ``raw / float32(maxval)``, each bit-equal to the JAX
    package's, and apart on some values by one ULP."""
    from siril_tpu.io.ser import SerFile as JSer
    from siril_tpu.planetary import source as jsrc

    _, frames = _noisy_frames(seed=5, n=6, size=64)
    _write_ser(tmp_path / "v.ser", frames)
    jseq = JSeq.from_ser(str(tmp_path / "v.ser"))
    tseq = TSeq.from_ser(str(tmp_path / "v.ser"))
    idx = np.array([4, 1, 5])
    (_, jdev), = list(jsrc.frame_chunks(jseq, idx, 0, 8))
    (_, tdev), = list(tsrc.frame_chunks(tseq, idx, 0, 8, CPU))
    assert tsrc.ser_device_store(tseq, 0, CPU) is not None
    assert np.array_equal(tdev.numpy(), np.asarray(jdev))
    host = np.stack([tseq.read_frame(int(i)).host()[0] for i in idx])
    jhost = np.stack([JSer(str(tmp_path / "v.ser")).read_frame(int(i))
                      .host()[0] for i in idx])
    assert np.array_equal(host, jhost)
    assert (host != tdev.numpy()).any()
    assert np.abs(host - tdev.numpy()).max() <= 6e-8


def test_mpp_stages_vs_jax(video):
    js, ts = video["js"], video["ts"]
    assert int(np.argmax(js.quality)) == int(np.argmax(ts.quality))
    assert np.abs(ts.quality / js.quality - 1).max() <= 1e-5
    assert np.abs(ts.global_shifts - js.global_shifts).max() <= 1e-3
    assert np.abs(ts.reference - js.reference).max() <= 1e-5
    assert np.array_equal(ts.ap_xy, js.ap_xy) and len(ts.ap_xy) > 10
    d = np.abs(ts.ap_shifts - js.ap_shifts).max(-1)
    assert (d <= 1e-3).mean() >= 0.95 and d.max() <= 1e-2, d.max()
    assert np.abs(ts.ap_quality / js.ap_quality - 1).max() <= 1e-4
    n_keep = max(int(round(len(js.quality) * 0.5)), 1)
    jsel = np.sort(np.argsort(-js.ap_quality, axis=0)[:n_keep], axis=0)
    tsel = np.sort(np.argsort(-ts.ap_quality, axis=0)[:n_keep], axis=0)
    for a in np.nonzero((jsel != tsel).any(0))[0]:
        q = js.ap_quality[:, a]
        edge = np.sort(q)[::-1][n_keep - 1:n_keep + 1]
        assert abs(edge[0] / edge[1] - 1) <= 1e-4, a
    assert np.abs(video["timg"].host() - video["jimg"].host()).max() <= 2e-4


def test_mpp_golden(tmp_path):
    """The port's stage outputs on ``TestMPPGolden``'s fixture against the
    committed golden, at that test's tolerances."""
    frames = jstages.TestMPPGolden()._fixture()
    for i, f in enumerate(frames):
        jwrite_fits(JImage(data=np.clip(f, 0, 1)[None].astype(np.float32)),
                    str(tmp_path / f"pl_{i:05d}.fit"), bitdepth=16)
    seq = TSeq.scan("pl_", str(tmp_path))
    args = tmpp.MPPArgs(global_best_pct=100.0)
    st = tmpp.mpp_compute_shifts(seq, tmpp.mpp_analyze(seq, args, CPU),
                                 args, CPU)
    exp = np.load(jstages.GOLDEN)
    assert np.array_equal(np.argsort(exp["quality"]), np.argsort(st.quality))
    np.testing.assert_allclose(st.quality, exp["quality"], rtol=1e-4)
    np.testing.assert_allclose(st.global_shifts, exp["global_shifts"],
                               atol=0.02)
    assert np.array_equal(st.ap_xy.astype(np.int64), exp["ap_xy"])
    S, half = 48, 24
    std = np.array([st.reference[int(np.clip(y - half, 0, 256 - S)):][:S,
                    int(np.clip(x - half, 0, 256 - S)):][:, :S].std()
                    for x, y in st.ap_xy])
    keep = std > 0.02
    assert keep.sum() >= len(keep) - 2
    np.testing.assert_allclose(st.ap_shifts[:, keep],
                               exp["ap_shifts"][:, keep], atol=0.05)


def test_sidecar_read_across(video, tmp_path):
    video["js"].save(str(tmp_path / "j.mpp"))
    video["ts"].save(str(tmp_path / "t.mpp"))
    a = tmpp.MPPState.load(str(tmp_path / "j.mpp"))
    b = jmpp.MPPState.load(str(tmp_path / "t.mpp"))
    for k in ("quality", "global_shifts", "reference", "ap_xy",
              "ap_shifts", "ap_quality"):
        assert np.array_equal(getattr(a, k), getattr(video["js"], k)), k
        assert np.array_equal(getattr(b, k), getattr(video["ts"], k)), k
    assert a.args.ap_size == b.args.ap_size == 48


def test_commands_vs_jax(video, tmp_path, caplog):
    from tests.test_torch_analysis import Both

    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(video["dir"] / "planet.ser", src / "planet.ser")
    both = Both(tmp_path, caplog, src)
    (_, jl), (_, tl) = both.run("seqquality planet")
    assert re.findall(r"(\d+) \(", tl[-1]) == re.findall(r"(\d+) \(",
                                                         jl[-1])
    from siril_tpu.io.seqfile import read_seqfile as jread
    from siril_tpu_torch.io.seqfile import read_seqfile as tread

    jr = jread(str(both.dirs["jax"] / "planet.seq")).reg(0).quality
    tr = tread(str(both.dirs["port"] / "planet.seq")).reg(0).quality
    assert np.abs(tr - jr).max() <= 1e-5
    assert np.array_equal(np.argsort(-tr)[:5], np.argsort(-jr)[:5])
    both.run("mpp planet -out=m")
    both.same_image(2e-4)
    mpp_img = both.t.image.host()
    both.run("register_mpp planet")
    both.run("stack_mpp planet -out=s")
    both.same_image(2e-4)
    assert np.array_equal(both.t.image.host(), mpp_img)
    for who in ("jax", "port"):
        assert (both.dirs[who] / "m.fit").exists()
        assert (both.dirs[who] / "s.fit").exists()
        assert (both.dirs[who] / "planet.mpp").exists()
    # rgbcomp -align: R and B moved by known sub-pixel shifts
    scene = video["scene"]
    chans = {"r": (1.3, -0.7), "g": (0.0, 0.0), "b": (-0.6, 1.1)}
    for name, (dx, dy) in chans.items():
        f = ndshift(scene, (dy, dx), order=3, mode="nearest")
        f = (f + np.random.default_rng(len(name)).normal(0, 0.005, f.shape))
        for who in ("jax", "port"):
            jwrite_fits(JImage(data=f[None].astype(np.float32)),
                        str(both.dirs[who] / f"{name}.fit"))
    both.run("rgbcomp r g b -align -out=rgb")
    both.same_image(1e-4)
    with pytest.raises(Exception):
        from siril_tpu_torch.cli.commands import COMMANDS

        COMMANDS["stack_mpp"].fn(both.t, ["nothing"])
