"""The port's sirilpy surface (``siril_tpu_torch/pythonmodule``) against the
JAX package's on the CPU: the wire server opcode by opcode, the wire
formats, ``SirilInterface`` and ``pyscript`` end to end.

The wire test starts a JAX server and a port server on sessions that hold
the same image (loaded from one FITS file) and the same 4-frame sequence,
and sends every opcode of the JAX server's ``_HANDLERS`` through one raw
client to both, in the same order.  Each reply's status and payload, and
the bytes of every shared-memory segment a reply names, must be equal;
masked are only the fields that name a path (the working directory, a
frame's file), a segment, or the log (each package keeps its own buffer:
the last line, the message just sent, is compared).  Two replies come
from each package's own float32 PSF fit and are compared as numbers:
ANALYSE_IMAGE_FROM_FILE's FWHM and roundness (1e-4) and
GET_STAR_IN_SELECTION's star (2e-3 relative).
"""

import os
import socket
import struct
import subprocess
import sys
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from siril_tpu.cli.context import Session as JSession
from siril_tpu.core.image import SirilImage as JImage
from siril_tpu.io.fits_io import write_fits as jwrite
from siril_tpu.pythonmodule import server as jsrv
from siril_tpu.pythonmodule import wire_formats as jwf
from siril_tpu_torch.cli.context import Session as TSession
from siril_tpu_torch.pythonmodule import server as tsrv
from siril_tpu_torch.pythonmodule import wire_formats as twf

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = struct.Struct("@Niiii256s")
NET = struct.Struct(jwf.NET_SHM_INFO)
INFO = struct.Struct("!IIIIQ256s")


def _request(path, cmd, payload=b""):
    s = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    s.connect(path)
    try:
        s.sendall(struct.pack("!Bi", cmd, len(payload)) + payload)
        hdr = b""
        while len(hdr) < 5:
            hdr += s.recv(5 - len(hdr))
        status, length = struct.unpack("!BI", hdr)
        data = b""
        while len(data) < length:
            data += s.recv(length - len(data))
    finally:
        s.close()
    return status, data


def _segment(name: str, size: int) -> bytes:
    shm = shared_memory.SharedMemory(name=name.lstrip("/"))
    try:
        return bytes(shm.buf[:size])
    finally:
        shm.close()


def _scene(seed=5, h=40, w=56):
    rng = np.random.default_rng(seed)
    data = (0.2 + 0.3 * rng.random((3, h, w))).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    data += 0.5 * np.exp(-((xx - 28.3) ** 2 + (yy - 20.6) ** 2) / 4.5)
    return data.astype(np.float32)


class Servers:
    """A JAX and a port server on sessions in their own directories with
    the same image and sequence; ``send`` asks both and returns both
    replies."""

    def __init__(self, tmp_path):
        from siril_tpu_torch.core.image import SirilImage as TImage

        self.dirs = {k: tmp_path / k for k in ("jax", "port")}
        rng = np.random.default_rng(3)
        frames = [rng.uniform(0.1, 0.5, (1, 16, 20)).astype(np.float32)
                  for _ in range(4)]
        img = JImage(data=_scene())
        img.keywords.object = "M42"
        img.keywords.exposure = 120.0
        for d in self.dirs.values():
            d.mkdir()
            jwrite(img, str(d / "scene.fit"), bitdepth=-32)
            for i, f in enumerate(frames):
                im = JImage(data=f)
                im.keywords.exposure = 10.0
                jwrite(im, str(d / f"sq_{i + 1:05d}.fit"), bitdepth=-32)
        self.j = JSession(cwd=str(self.dirs["jax"]))
        self.t = TSession(cwd=str(self.dirs["port"]), device="cpu")
        from siril_tpu.cli.parser import process_command_line as jrun
        from siril_tpu_torch.cli.parser import process_command_line as trun

        assert jrun(self.j, "load scene") == 0
        assert trun(self.t, "load scene") == 0
        self.j.load_sequence("sq_")
        self.t.load_sequence("sq_")
        for seq in (self.j.seq, self.t.sequence):
            reg = seq.reg(0)
            for k in range(4):
                reg.H[k] = np.eye(3)
                reg.valid[k] = True
                reg.quality[k] = 0.5 + 0.1 * k
        # one star list for both (the fitters part in the last bits)
        from siril_tpu.registration.psf import PSFStar

        stars = [PSFStar(B=0.2, A=0.5, x0=28.8, y0=21.1, sx=1.5, sy=1.4,
                         fwhmx=3.5, fwhmy=3.3, angle=10.0, rmse=0.01,
                         mag=-1.2, snr=40.0)]
        self.j.stars = list(stars)
        self.t.stars = list(stars)
        self.js = jsrv.PythonCommandServer(
            self.j, socket_path=str(tmp_path / "j.sock"))
        self.ts = tsrv.PythonCommandServer(
            self.t, socket_path=str(tmp_path / "t.sock"))
        self.js.start()
        self.ts.start()
        self.sent = set()
        self.TImage = TImage

    def stop(self):
        self.js.stop()
        self.ts.stop()

    def send(self, cmd, payload=b""):
        """Both replies; ``payload`` may be a function of the server."""
        self.sent.add(cmd)
        out = []
        for srv in (self.js, self.ts):
            p = payload(srv) if callable(payload) else payload
            out.append(_request(srv.socket_path, cmd, p))
        return out

    def same(self, cmd, payload=b""):
        (sj, dj), (st, dt) = self.send(cmd, payload)
        assert (sj, dj) == (st, dt), (cmd, sj, dj[:200], st, dt[:200])
        return sj, dj

    def same_shm(self, cmd, payload=b""):
        """A reply naming a segment: the struct but its name, and the
        segment's bytes; then RELEASE_SHM."""
        (sj, dj), (st, dt) = self.send(cmd, payload)
        assert sj == st, (cmd, sj, st, dj[:100], dt[:100])
        if sj != jsrv.STATUS_OK:
            assert dj == dt, cmd
            return sj, None
        ij, it = NATIVE.unpack(dj), NATIVE.unpack(dt)
        assert ij[:5] == it[:5], (cmd, ij[:5], it[:5])
        names = [i[5].split(b"\0")[0].decode() for i in (ij, it)]
        assert names[0].startswith("siril_tpu_") and \
            names[1].startswith("siril_tpu_torch_")
        bj, bt = _segment(names[0], ij[0]), _segment(names[1], it[0])
        assert bj == bt, cmd
        self.release(dj, dt)
        return sj, bj

    def release(self, dj, dt):
        self.sent.add(jsrv.CMD_RELEASE_SHM)
        for srv, d in ((self.js, dj), (self.ts, dt)):
            assert _request(srv.socket_path, jsrv.CMD_RELEASE_SHM, d) == \
                (jsrv.STATUS_OK, b"")

    def client_segment(self, data: bytes):
        """REQUEST_SHM on both servers, ``data`` written into each: a
        function of the server → its segment's name."""
        (sj, dj), (st, dt) = self.send(jsrv.CMD_REQUEST_SHM,
                                       struct.pack("!Q", len(data)))
        assert sj == st == jsrv.STATUS_OK
        assert NATIVE.unpack(dj)[:5] == NATIVE.unpack(dt)[:5]
        names = {}
        for srv, d in ((self.js, dj), (self.ts, dt)):
            name = NATIVE.unpack(d)[5].split(b"\0")[0].decode()
            shm = shared_memory.SharedMemory(name=name)
            shm.buf[:len(data)] = data
            shm.close()
            names[id(srv)] = name
        return lambda srv: names[id(srv)]

    def release_client(self, seg):
        """RELEASE_SHM of a client-filled segment (SET_PIXELDATA keeps
        it, as the sirilpy client releases it itself)."""
        self.release(*(b"\0" * 8 + seg(srv).encode().ljust(256, b"\0")
                       for srv in (self.js, self.ts)))

    def net_blocks(self, cmd, payload, head: int):
        """A reply of ``head`` plain bytes then network-order shm infos:
        the head equal, each info but its name equal, each segment's
        bytes equal."""
        (sj, dj), (st, dt) = self.send(cmd, payload)
        assert sj == st == jsrv.STATUS_OK, (cmd, dj[:200], dt[:200])
        assert dj[:head] == dt[:head], cmd
        rest_j, rest_t = dj[head:], dt[head:]
        assert len(rest_j) == len(rest_t) and len(rest_j) % NET.size == 0
        for off in range(0, len(rest_j), NET.size):
            ij = NET.unpack(rest_j[off:off + NET.size])
            it = NET.unpack(rest_t[off:off + NET.size])
            assert ij[:5] == it[:5], cmd
            if ij[0]:
                nj = ij[5].split(b"\0")[0].decode()
                nt = it[5].split(b"\0")[0].decode()
                assert _segment(nj, ij[0]) == _segment(nt, it[0]), cmd
                self.release(b"\0" * 8 + ij[5], b"\0" * 8 + it[5])


@pytest.fixture
def servers(tmp_path):
    b = Servers(tmp_path)
    yield b
    b.stop()


def _plotdata() -> bytes:
    buf = b"t\0x\0y\0\0" + struct.pack("!?I", True, 1) + \
        struct.pack("!?", False) + struct.pack("!?", False)
    buf += b"line\0" + struct.pack("!?II", False, 3, 0)
    for x, y in ((1.0, 2.0), (2.0, 4.0), (3.0, 6.0)):
        buf += struct.pack("!dd", x, y)
    return buf


def _polygon(pid=0, pts=((2, 3), (12, 3), (12, 11), (2, 11)),
             legend="box"):
    return jwf.serialize_polygon(dict(polygon_id=pid, points=list(pts),
                                      color=0x11223344, fill=False,
                                      legend=legend))


def test_wire_server_opcodes_vs_jax(servers):
    """Every opcode of the JAX server's ``_HANDLERS``: the same status,
    payload and segment bytes from the port's server."""
    b = servers
    S = jsrv
    info = lambda a, bb, c, d, size, seg: (  # noqa: E731
        lambda srv: INFO.pack(a, bb, c, d, size,
                              seg(srv).encode().ljust(256, b"\0")))
    # the image, its metadata and pixels
    b.same(S.CMD_GET_IS_IMAGE_LOADED)
    b.same(S.CMD_GET_IS_SEQUENCE_LOADED)
    b.same(S.CMD_GET_FILENAME)
    b.same(S.CMD_GET_DIMENSIONS)
    b.same(S.CMD_GET_KEYWORDS)
    b.same(S.CMD_GET_IMAGE)
    b.same_shm(S.CMD_GET_FITS_HEADER)
    b.same(S.CMD_GET_IMAGE_STATS, struct.pack("!I", 1))
    b.same_shm(S.CMD_GET_PIXELDATA, b"\x00\x01")
    b.same_shm(S.CMD_GET_PIXELDATA, b"\x01\x01")
    b.same_shm(S.CMD_GET_PIXELDATA_REGION,
               b"\x00\x01" + struct.pack("!IIII", 4, 6, 10, 8))
    b.same(S.CMD_SEND_COMMAND, b"neg")
    b.same(S.CMD_SEND_COMMAND, b"no_such_command")
    b.same_shm(S.CMD_GET_FITS_HISTORY)
    b.same_shm(S.CMD_GET_PSFSTARS)
    b.same(S.CMD_GET_ICC_PROFILE)
    b.same(S.CMD_GET_DISPLAY_ICCPROFILE)
    # pixels in through a client segment
    new = (_scene(9) * 0.5).astype(np.float32)
    seg = b.client_segment(new.tobytes())
    b.same(S.CMD_SET_PIXELDATA, info(56, 40, 3, 1, new.nbytes, seg))
    b.release_client(seg)
    b.same_shm(S.CMD_GET_PIXELDATA, b"\x00\x01")
    # the log, progress, messages
    b.same(S.CMD_LOG_MESSAGE, b"\x00a wire log line")
    (sj, dj), (st, dt) = b.send(S.CMD_GET_SIRIL_LOG)
    assert sj == st == S.STATUS_OK
    last = []
    for d in (dj, dt):
        size, _, _, _, _, name = NATIVE.unpack(d)
        last.append(_segment(name.split(b"\0")[0].decode(), size)
                    .rstrip(b"\0").split(b"\n")[-1])
    assert last == [b"a wire log line"] * 2
    b.release(dj, dt)
    b.same(S.CMD_UPDATE_PROGRESS, struct.pack("!f", 0.5) + b"half\0")
    for op in (S.CMD_ERROR_MESSAGEBOX, S.CMD_ERROR_MESSAGEBOX_MODAL,
               S.CMD_INFO_MESSAGEBOX, S.CMD_INFO_MESSAGEBOX_MODAL,
               S.CMD_WARNING_MESSAGEBOX, S.CMD_WARNING_MESSAGEBOX_MODAL):
        b.same(op, b"a message\0")
    b.same(S.CMD_CONFIRM_MESSAGEBOX, b"title\0go ahead?\0OK\0")
    b.same(S.CMD_CLAIM_THREAD)
    b.same(S.CMD_RELEASE_THREAD)
    # selection, stars and statistics in it
    b.same(S.CMD_GET_SELECTION)
    b.same(S.CMD_SET_SELECTION, struct.pack("!IIII", 2, 3, 10, 12))
    b.same(S.CMD_GET_SELECTION)
    b.same(S.CMD_GET_STATS_FOR_SELECTION, struct.pack("!IIIII", 0, 0, 20,
                                                      20, 1))
    b.same(S.CMD_GET_STATS_FOR_SELECTION, struct.pack("!I", 0))
    # WCS (the image is not plate solved)
    b.same(S.CMD_PIX2WCS, struct.pack("!2d", 1.0, 2.0))
    b.same(S.CMD_WCS2PIX, struct.pack("!2d", 10.0, 20.0))
    # paths and configuration
    (sj, dj), (st, dt) = b.send(S.CMD_GET_WORKING_DIRECTORY)
    assert (sj, dj, st, dt) == (S.STATUS_OK, str(b.dirs["jax"]).encode()
                                + b"\0", S.STATUS_OK,
                                str(b.dirs["port"]).encode() + b"\0")
    for op in (S.CMD_GET_USERCONFIG_DIR, S.CMD_GET_USERDATA_DIR,
               S.CMD_GET_SYSTEMDATA_DIR, S.CMD_GET_BUNDLE_PATH,
               S.CMD_GET_ACTIVE_VPORT):
        b.same(op)
    for key in (b"core\0extension\0", b"core\0memory_ratio\0",
                b"core\0force_16bit\0", b"core\0cpu_threads\0",
                b"core\0debayer_method\0", b"core\0no_such_key\0"):
        b.same(S.CMD_GET_CONFIG, key)
    # undo
    b.same(S.CMD_UNDO_SAVE_STATE, b"before neg\0")
    b.same(S.CMD_SEND_COMMAND, b"neg")
    b.same(S.CMD_UNDO)
    b.same_shm(S.CMD_GET_PIXELDATA, b"\x00\x01")
    b.same(S.CMD_REDO)
    b.same_shm(S.CMD_GET_PIXELDATA, b"\x00\x01")
    b.same(S.CMD_CLEAR_UNDO_HISTORY)
    # ICC, header, file name
    icc = b"fake-icc-profile-bytes"
    seg = b.client_segment(icc)
    b.same(S.CMD_SET_IMAGE_ICCPROFILE, info(0, 0, 0, 0, len(icc), seg))
    b.same_shm(S.CMD_GET_ICC_PROFILE)
    hdr = b"TESTKEY =                   42\0"
    seg = b.client_segment(hdr)
    b.same(S.CMD_SET_IMAGE_HEADER, info(0, 0, 0, 0, len(hdr), seg))
    b.same_shm(S.CMD_GET_FITS_UNKNOWN_KEYS)
    b.same(S.CMD_SET_IMAGE_FILENAME, b"renamed\0")
    b.same(S.CMD_GET_FILENAME)
    # background samples
    b.same(S.CMD_GET_BGSAMPLES)
    one = jwf.BGSAMPLE_NATIVE_FORMAT
    samples = struct.pack(one * 2, 0, 0, 0, 0, 0, 0, 25, 5.0, 6.0, 1,
                          0, 0, 0, 0, 0, 0, 25, 20.0, 22.0, 1)
    seg = b.client_segment(samples)
    b.same(S.CMD_SET_BGSAMPLES, info(0, 0, 1, 0, len(samples), seg))
    b.same_shm(S.CMD_GET_BGSAMPLES)
    b.same(S.CMD_CLEAR_BGSAMPLES)
    b.same(S.CMD_GET_BGSAMPLES)
    # overlay polygons
    poly = _polygon()
    seg = b.client_segment(poly)
    (sj, dj) = b.same(S.CMD_ADD_USER_POLYGON, info(0, 0, 0, 0, len(poly),
                                                   seg))
    (pid,) = struct.unpack("!i", dj)
    b.same_shm(S.CMD_GET_USER_POLYGON, struct.pack("!i", pid))
    b.same_shm(S.CMD_GET_USER_POLYGON_LIST)
    b.same(S.CMD_DELETE_USER_POLYGON, struct.pack("!i", pid))
    b.same(S.CMD_GET_USER_POLYGON, struct.pack("!i", pid))
    b.same(S.CMD_CLEAR_USER_POLYGONS)
    b.same(S.CMD_GET_USER_POLYGON_LIST)
    b.same(S.CMD_DRAW_POLYGON)
    b.same(S.CMD_OPEN_DIALOG)
    # masks
    b.same(S.CMD_GET_IMAGE_MASK)
    b.same(S.CMD_GET_IMAGE_MASK_STATE)
    mask = np.zeros((40, 56), np.float32)
    mask[10:20, 10:20] = 1.0
    seg = b.client_segment(mask.tobytes())
    b.same(S.CMD_SET_IMAGE_MASK, info(56, 40, 1, 32, mask.nbytes, seg))
    b.same(S.CMD_SET_IMAGE_MASK_STATE, b"\x01")
    b.same(S.CMD_GET_IMAGE_MASK_STATE)
    poly = _polygon(pts=((30, 30), (38, 30), (38, 36), (30, 36)),
                    legend=None)
    seg = b.client_segment(poly)
    b.same(S.CMD_MASK_UPDATE_POLYGON, info(1, 0, 0, 0, len(poly), seg))
    b.same_shm(S.CMD_GET_IMAGE_MASK)
    # display state
    b.same(S.CMD_GET_SLIDER_STATE)
    b.same(S.CMD_SET_SLIDER_MODE, struct.pack("!I", 1))
    b.same(S.CMD_SET_SLIDER_LOHI, struct.pack("!II", 100, 50000))
    b.same(S.CMD_GET_SLIDER_STATE)
    b.same(S.CMD_GET_STFMODE)
    b.same(S.CMD_SET_STFMODE, struct.pack("!I", 2))
    b.same(S.CMD_GET_STFMODE)
    b.same(S.CMD_GET_PANZOOM)
    b.same(S.CMD_SET_PAN, struct.pack("!dd", 3.0, 4.0))
    b.same(S.CMD_SET_ZOOM, struct.pack("!d", 2.0))
    b.same(S.CMD_GET_PANZOOM)
    b.same(S.CMD_GET_STF_LINKED)
    b.same(S.CMD_SET_STF_LINKED, b"\x00")
    b.same(S.CMD_GET_STF_LINKED)
    # a plot (its .dat in each working directory)
    pd = _plotdata()
    seg = b.client_segment(pd)
    b.same(S.CMD_SIRIL_PLOT, info(1, 0, 0, 0, len(pd), seg))
    # the sequence
    b.same(S.CMD_GET_IS_SEQUENCE_LOADED)
    b.same(S.CMD_GET_SEQ)
    b.same(S.CMD_GET_SEQ_IMGDATA, struct.pack("!I", 1))
    b.same(S.CMD_GET_SEQ_REGDATA, struct.pack("!II", 2, 0))
    b.same(S.CMD_GET_SEQ_STATS, struct.pack("!II", 1, 0))
    b.same(S.CMD_GET_SEQ_DISTODATA, struct.pack("!I", 0))
    b.same_shm(S.CMD_GET_SEQ_PIXELDATA, b"\x00\x01" + struct.pack("!I", 1))
    b.same_shm(S.CMD_GET_SEQ_PIXELDATA, b"\x00\x01" + struct.pack(
        "!IIIII", 1, 2, 3, 8, 6))
    b.same_shm(S.CMD_GET_SEQ_FRAME_HEADER, struct.pack("!I", 1))
    (sj, dj), (st, dt) = b.send(S.CMD_GET_SEQ_FRAME_FILENAME,
                                struct.pack("!I", 1))
    assert sj == st == S.STATUS_OK
    assert os.path.basename(dj.rstrip(b"\0")) == \
        os.path.basename(dt.rstrip(b"\0")) == b"sq_00002.fit"
    head = struct.calcsize(jwf.CORE_FFIT_FORMAT) + \
        struct.calcsize(jwf.KEYWORDS_FORMAT)
    b.net_blocks(S.CMD_GET_SEQ_IMAGE, struct.pack("!I???", 2, True, False,
                                                  False), head)
    b.net_blocks(S.CMD_GET_SEQ_IMAGE, struct.pack("!I???", 2, True, True,
                                                  False), head)
    b.same(S.CMD_SET_SEQ_FRAME_INCL, struct.pack("!Ii", 2, 0))
    b.same(S.CMD_GET_SEQ)
    frame = np.full((16, 20), 0.33, np.float32)
    for i in range(4):
        seg = b.client_segment(frame.tobytes())
        b.same(S.CMD_SEQ_FRAME_SET_PIXELDATA, lambda srv, seg=seg, i=i:
               struct.pack("!i", i) + info(20, 16, 1, 1, frame.nbytes,
                                           seg)(srv) + b"pp_\0")
    for d in b.dirs.values():
        assert (d / "pp_sq_00004.fit").exists()
    b.same(S.CMD_CREATE_NEW_SEQ, b"pp_sq_\0")
    b.same(S.CMD_GET_SEQ)
    # files: read, analyse, save
    path = lambda srv: str(  # noqa: E731
        b.dirs["jax" if srv is b.js else "port"] / "scene.fit").encode()
    b.net_blocks(S.CMD_GET_IMAGE_FILE, lambda srv: b"\x01\x00\x00" +
                 path(srv) + b"\0", head + 3 * 14 * 8)
    b.net_blocks(S.CMD_GET_IMAGE_FILE, lambda srv: b"\x00\x00\x00" +
                 path(srv) + b"\0", head + 3 * 14 * 8)
    (sj, dj), (st, dt) = b.send(S.CMD_ANALYSE_IMAGE_FROM_FILE,
                                lambda srv: path(srv) + b"\0")
    assert sj == st == S.STATUS_OK
    aj = struct.unpack(jwf.ANALYSIS_FORMAT, dj)
    at = struct.unpack(jwf.ANALYSIS_FORMAT, dt)
    # bgnoise and the shape exactly; the star counts and FWHMs come from
    # each package's detection (its float32 fit)
    assert aj[0] == at[0] and aj[5:] == at[5:]
    assert aj[3] == at[3] and abs(aj[1] - at[1]) <= 1e-4 * abs(aj[1]) \
        and abs(aj[4] - at[4]) <= 1e-4
    arr = np.full((10, 11), 0.2, np.float32)
    hdr = b"OBJECT  = 'SAVED'\0"
    seg_i = b.client_segment(arr.tobytes())
    seg_h = b.client_segment(hdr)
    b.same(S.CMD_SAVE_IMAGE_FILE, lambda srv: info(
        11, 10, 1, 1, arr.nbytes, seg_i)(srv) + struct.pack(
        "!Q256s", len(hdr), seg_h(srv).encode()) +
        b"saved.fit".ljust(256, b"\0"))
    assert (b.dirs["jax"] / "saved.fit").read_bytes() == \
        (b.dirs["port"] / "saved.fit").read_bytes()
    # a selection star: both fit the planted star (on the scene again)
    star = _scene()
    seg = b.client_segment(star.tobytes())
    b.same(S.CMD_SET_PIXELDATA, info(56, 40, 3, 1, star.nbytes, seg))
    b.release_client(seg)
    (sj, dj), (st, dt) = b.send(S.CMD_GET_STAR_IN_SELECTION, struct.pack(
        "!IIIIII", 20, 12, 17, 17, 0, 0))
    assert sj == st == S.STATUS_OK
    fj = np.array(struct.unpack(jwf.PSFSTAR_FORMAT, dj), float)
    ft = np.array(struct.unpack(jwf.PSFSTAR_FORMAT, dt), float)
    # the two float32 LM fits part in the fourth digit of the widths
    assert np.allclose(fj, ft, rtol=2e-3, atol=1e-4), (fj, ft)
    missing = set(jsrv.PythonCommandServer._HANDLERS) - b.sent
    assert not missing, sorted(missing)
    assert set(tsrv.PythonCommandServer._HANDLERS) == \
        set(jsrv.PythonCommandServer._HANDLERS)
    assert not b.js._shm and not b.ts._shm


def test_wire_formats_byte_equal():
    """The packers of both packages on the same records."""
    from siril_tpu.core.image import SirilImage as JI
    from siril_tpu.ops.statistics import STATS_MAIN, compute_stats_np
    from siril_tpu_torch.core.image import SirilImage as TI

    d = _scene()
    ji, ti = JI(data=d.copy()), TI(data=d.copy())
    for im in (ji, ti):
        im.keywords.object = "NGC 1"
        im.keywords.date_obs = "2024-01-02T03:04:05"
        im.keywords.exposure = 30.0
        im.keywords.stackcnt = 7
    assert jwf.pack_keywords(ji) == twf.pack_keywords(ti)
    assert jwf.pack_core_ffit(ji) == twf.pack_core_ffit(ti)
    st = compute_stats_np(d[0], STATS_MAIN)
    assert jwf.pack_stats(st) == twf.pack_stats(st)
    assert jwf.stats14(st) == twf.stats14(st)
    rd = dict(fwhm=2.5, weighted_fwhm=2.6, roundness=0.9, quality=0.7,
              background_lvl=0.1, number_of_stars=12,
              H=np.arange(9.0).reshape(3, 3))
    assert jwf.pack_regdata(rd) == twf.pack_regdata(rd)
    im = dict(filenum=3, incl=False, date_obs="2024-05-06T07:08:09Z",
              airmass=1.2, rx=20, ry=16)
    assert jwf.pack_imgdata(im) == twf.pack_imgdata(im)
    an = dict(bgnoise=0.01, fwhm=3.0, wfwhm=3.1, nbstars=5, roundness=0.8,
              imagetype=0, timestamp=17, channels=3, height=4, width=5,
              filter="Ha")
    assert jwf.pack_analysis(an) == twf.pack_analysis(an)
    bg = dict(median=(0.1, 0.2, 0.3), mean=0.2, min=0.0, max=0.5, size=25,
              position=(3.0, 4.0), valid=True)
    assert jwf.pack_bgsample(bg) == twf.pack_bgsample(bg)
    poly = _polygon()
    assert twf.deserialize_polygon(poly) == jwf.deserialize_polygon(poly)
    assert twf.serialize_polygon(jwf.deserialize_polygon(poly)[0]) == poly
    assert twf.deserialize_plotdata(_plotdata()) == \
        jwf.deserialize_plotdata(_plotdata())
    raw = struct.pack(jwf.BGSAMPLE_NATIVE_FORMAT * 2,
                      *range(10), *range(10, 20))
    assert twf.unpack_native_bgsamples(raw) == \
        jwf.unpack_native_bgsamples(raw)


def test_interface_vs_jax(tmp_path):
    """SirilInterface on both sessions: pixels, undo points, the log
    buffer, progress, configuration, shape and statistics."""
    from siril_tpu.pythonmodule import SirilInterface as JI
    from siril_tpu.utils.log import add_progress_hook as jhook
    from siril_tpu_torch.pythonmodule import SirilInterface as TI
    from siril_tpu_torch.utils.log import (
        add_progress_hook,
        remove_progress_hook,
    )

    d = _scene()
    out = {}
    for who, I, S in (("jax", JI, JSession), ("port", TI, TSession)):
        wd = tmp_path / who
        wd.mkdir()
        jwrite(JImage(data=d), str(wd / "a.fit"), bitdepth=-32)
        kw = {} if who == "jax" else {"device": "cpu"}
        s = I(S(cwd=str(wd), **kw))
        s.connect()
        s.cmd("load", "a.fit")
        px = s.get_image_pixeldata()
        s.set_image_pixeldata(px * 0.5)
        s.undo_save_state("scaled")
        s.cmd("mirrorx")
        hist = list(s.ctx.undo_stack.history())
        s.undo()
        after_undo = s.get_image_pixeldata().copy()
        s.redo()
        s.log("interface log line")
        prog = []
        fn = lambda f, t: prog.append((f, t))  # noqa: E731
        (jhook if who == "jax" else add_progress_hook)(fn)
        s.update_progress("half", 0.5)
        if who == "port":
            remove_progress_hook(fn)
        out[who] = dict(
            px=s.get_image_pixeldata(), hist=hist, undo=after_undo,
            shape=s.get_image_shape(), log=s.get_siril_log()[-1],
            prog=prog[-1], ext=s.get_siril_config("core", "extension"),
            ratio=s.get_siril_config("core", "memory_ratio"),
            stats=vars(s.get_image_stats(1)))
        s.cmd("close")
    j, t = out["jax"], out["port"]
    for k in ("px", "undo"):
        np.testing.assert_array_equal(t[k], j[k])
    for k in ("hist", "shape", "log", "prog", "ext", "ratio", "stats"):
        assert t[k] == j[k], k


def test_pyscript_end_to_end(tmp_path):
    """``pyscript``: a wire script reads the image through SHM, scales
    it, writes it back and runs a command through ``siril.cmd``; the
    result equals the JAX package's run of the same script, and the
    script's process loaded neither jax nor siril_tpu (nor torch)."""
    from siril_tpu.cli.parser import process_command_line as jrun
    from siril_tpu_torch.cli.parser import process_command_line as trun

    d = _scene()
    res = {}
    for who in ("jax", "port"):
        wd = tmp_path / who
        wd.mkdir()
        jwrite(JImage(data=d), str(wd / "a.fit"), bitdepth=-32)
        mods = wd / "mods.txt"
        (wd / "s.py").write_text(
            "import sys\n"
            "px = siril.get_image_pixeldata()\n"
            "siril.set_image_pixeldata(px * 0.5)\n"
            "siril.cmd('mirrorx')\n"
            f"open({str(mods)!r}, 'w').write(repr(sorted(m for m in "
            "sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'siril_tpu', 'torch'))))\n")
        if who == "jax":
            s = JSession(cwd=str(wd))
            run = jrun
        else:
            s = TSession(cwd=str(wd), device="cpu")
            run = trun
        assert run(s, "load a") == 0
        assert run(s, "pyscript s.py") == 0
        res[who] = (s.image.host().copy(), s.undo_stack.history(),
                    mods.read_text())
    np.testing.assert_array_equal(res["port"][0], res["jax"][0])
    np.testing.assert_array_equal(res["port"][0], (d * 0.5)[:, ::-1])
    assert res["port"][1] == res["jax"][1]
    assert res["port"][2] == "[]"
    assert res["jax"][2] != "[]"          # the JAX bootstrap's imports


def test_pyscript_failure_and_client_releases_shm(tmp_path):
    """A failing script is a command error; the wire client leaks no
    server segment over get / set round trips."""
    from siril_tpu_torch.cli.parser import process_command_line
    from siril_tpu_torch.core.image import SirilImage
    from siril_tpu_torch.pythonmodule.client import SirilWireClient

    s = TSession(cwd=str(tmp_path), device="cpu")
    s.set_image(SirilImage(data=np.full((1, 8, 8), 0.25, np.float32)), "x")
    (tmp_path / "bad.py").write_text("raise SystemExit(3)\n")
    assert process_command_line(s, "pyscript bad.py") == 1
    assert process_command_line(s, "pyscript missing.py") == 1
    srv = tsrv.PythonCommandServer(s, socket_path=str(tmp_path / "sock"))
    srv.start()
    try:
        cl = SirilWireClient(srv.socket_path)
        for _ in range(3):
            cl.set_image_pixeldata(cl.get_image_pixeldata() * 0.5)
        assert cl.get_image_shape() == (1, 8, 8)
        cl.cmd("neg")
        with pytest.raises(Exception):
            cl.cmd("no_such_command")
        cl.close()
        assert not srv._shm
    finally:
        srv.stop()
    np.testing.assert_allclose(s.image.data, 1.0 - 0.25 / 8, atol=1e-7)


def test_pyscript_needs_a_card(monkeypatch, tmp_path):
    """Without a card and without ``device="cpu"`` pyscript raises."""
    from siril_tpu_torch.cli.commands import COMMANDS
    from siril_tpu_torch.core.image import SirilImage

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (tmp_path / "s.py").write_text("pass\n")
    s = TSession(cwd=str(tmp_path))
    s.set_image(SirilImage(data=np.zeros((1, 4, 4), np.float32)), "x")
    with pytest.raises(RuntimeError, match="CUDA"):
        COMMANDS["pyscript"].fn(s, ["s.py"])
    from siril_tpu_torch.pythonmodule import SirilInterface

    with pytest.raises(RuntimeError, match="CUDA"):
        SirilInterface(s).set_image_pixeldata(np.zeros((4, 4), np.float32))


def test_client_imports_no_torch():
    """The wire client (the pyscript bootstrap's one import) loads
    neither torch nor the session."""
    code = ("import sys\n"
            "from siril_tpu_torch.pythonmodule.client import "
            "SirilWireClient\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('torch', 'jax', 'siril_tpu')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_export_sequence_avi_vs_jax(tmp_path):
    """``export_sequence_avi`` of the same sequence: byte-equal files."""
    from siril_tpu.pythonmodule import SirilInterface as JI
    from siril_tpu_torch.pythonmodule import SirilInterface as TI

    rng = np.random.default_rng(6)
    for i in range(3):
        jwrite(JImage(data=rng.random((3, 12, 16)).astype(np.float32)),
               str(tmp_path / f"v_{i + 1:05d}.fit"), bitdepth=-32)
    out = {}
    for who, I, S in (("jax", JI, JSession), ("port", TI, TSession)):
        s = I(S(cwd=str(tmp_path)))
        s.connect()
        s.ctx.load_sequence("v_")
        assert s.export_sequence_avi(f"{who}.avi", 10) == 3
        out[who] = (tmp_path / f"{who}.avi").read_bytes()
    assert out["port"] == out["jax"]
