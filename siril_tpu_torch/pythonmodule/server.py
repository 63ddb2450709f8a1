"""sirilpy wire protocol server — counterpart of
``siril_tpu/pythonmodule/server.py`` (``PythonCommandServer``:146, the
opcodes of ``_HANDLERS``:1081, ``run_python_script``:1177): socket +
shared-memory pixel transfer, byte for byte as the JAX server answers.

The default socket is ``siril_tpu_torch_<pid>.sock`` and the segments
``siril_tpu_torch_<pid>_<n>``, so that both packages' servers can run in
one process.

Byte-compatible with the reference's Python bridge
(``src/io/siril_pythonmodule.c`` / ``.h:15+``): an **unmodified**
``sirilpy`` client (reference python_module/sirilpy/) connects to the
AF_UNIX socket named by ``$MY_SOCKET`` and speaks:

  request  = header ``!Bi`` (command u8, payload length i32) + payload
  response = header ``!BI`` (status u8, payload length u32) + payload
  status   = 0 OK, 1 NONE ("allowed failure"), 0xFF ERROR

Pixel data crosses in POSIX shared memory: the server creates a segment,
fills it (GET_PIXELDATA*) or lets the client fill it (REQUEST_SHM →
SET_PIXELDATA with a ``!IIIIQ256s`` descriptor), and replies with the
native-endian ``_SharedMemoryInfo`` struct {size_t size; int data_type,
width, height, channels; char shm_name[256]} the client ctypes-parses.
RELEASE_SHM unlinks.

The opcode semantics are delegated to the in-process
``pythonmodule.connection.SirilInterface`` (the same Session the CLI
uses), so every command the script runs lands in the same state.
"""

from __future__ import annotations

import logging
import os
import socket
import struct
import threading
from multiprocessing import shared_memory
from typing import Dict, Optional

import numpy as np

_log = logging.getLogger(__name__)

# opcodes (siril_pythonmodule.h:15-110)
CMD_SEND_COMMAND = 1
CMD_LOG_MESSAGE = 2
CMD_UPDATE_PROGRESS = 3
CMD_GET_WORKING_DIRECTORY = 4
CMD_GET_FILENAME = 5
CMD_GET_DIMENSIONS = 6
CMD_GET_PIXELDATA = 7
CMD_GET_PIXELDATA_REGION = 8
CMD_RELEASE_SHM = 9
CMD_SET_PIXELDATA = 10
CMD_GET_IMAGE_STATS = 11
CMD_GET_KEYWORDS = 12
CMD_GET_ICC_PROFILE = 13
CMD_GET_FITS_HEADER = 14
CMD_GET_FITS_HISTORY = 15
CMD_GET_FITS_UNKNOWN_KEYS = 16
CMD_GET_IMAGE = 17
CMD_GET_PSFSTARS = 18
CMD_GET_SEQ_STATS = 19
CMD_GET_SEQ_REGDATA = 20
CMD_GET_SEQ_IMGDATA = 21
CMD_GET_SEQ_PIXELDATA = 22
CMD_GET_SEQ_IMAGE = 23
CMD_GET_SEQ = 24
CMD_GET_CONFIG = 25
CMD_GET_USERCONFIG_DIR = 26
CMD_GET_IS_IMAGE_LOADED = 27
CMD_GET_IS_SEQUENCE_LOADED = 28
CMD_GET_SELECTION = 29
CMD_SET_SELECTION = 30
CMD_GET_ACTIVE_VPORT = 31
CMD_GET_STAR_IN_SELECTION = 32
CMD_GET_STATS_FOR_SELECTION = 33
CMD_PIX2WCS = 34
CMD_WCS2PIX = 35
CMD_UNDO_SAVE_STATE = 36
CMD_GET_BUNDLE_PATH = 37
CMD_ERROR_MESSAGEBOX = 38
CMD_ERROR_MESSAGEBOX_MODAL = 39
CMD_SIRIL_PLOT = 40
CMD_CLAIM_THREAD = 41
CMD_RELEASE_THREAD = 42
CMD_SEQ_FRAME_SET_PIXELDATA = 43
CMD_REQUEST_SHM = 44
CMD_SET_SEQ_FRAME_INCL = 45
CMD_GET_USERDATA_DIR = 46
CMD_GET_SYSTEMDATA_DIR = 47
CMD_GET_BGSAMPLES = 48
CMD_SET_BGSAMPLES = 49
CMD_GET_SEQ_FRAME_FILENAME = 50
CMD_INFO_MESSAGEBOX = 51
CMD_INFO_MESSAGEBOX_MODAL = 52
CMD_WARNING_MESSAGEBOX = 53
CMD_WARNING_MESSAGEBOX_MODAL = 54
CMD_GET_SEQ_DISTODATA = 55
CMD_SET_IMAGE_HEADER = 56
CMD_ADD_USER_POLYGON = 57
CMD_DELETE_USER_POLYGON = 58
CMD_CLEAR_USER_POLYGONS = 59
CMD_GET_USER_POLYGON = 60
CMD_GET_USER_POLYGON_LIST = 61
CMD_CONFIRM_MESSAGEBOX = 62
CMD_GET_SEQ_FRAME_HEADER = 63
CMD_CREATE_NEW_SEQ = 64
CMD_CLEAR_BGSAMPLES = 65
CMD_DRAW_POLYGON = 66
CMD_GET_IMAGE_FILE = 67
CMD_ANALYSE_IMAGE_FROM_FILE = 68
CMD_UNDO = 69
CMD_REDO = 70
CMD_SET_IMAGE_ICCPROFILE = 71
CMD_CLEAR_UNDO_HISTORY = 72
CMD_GET_SLIDER_STATE = 73
CMD_SET_SLIDER_MODE = 74
CMD_SET_SLIDER_LOHI = 75
CMD_GET_STFMODE = 76
CMD_SET_STFMODE = 77
CMD_GET_PANZOOM = 78
CMD_SET_PAN = 79
CMD_SET_ZOOM = 80
CMD_GET_DISPLAY_ICCPROFILE = 81
CMD_GET_STF_LINKED = 82
CMD_SET_STF_LINKED = 83
CMD_SET_IMAGE_FILENAME = 84
CMD_GET_SIRIL_LOG = 85
CMD_SAVE_IMAGE_FILE = 86
CMD_GET_IMAGE_MASK = 87
CMD_SET_IMAGE_MASK = 88
CMD_SET_IMAGE_MASK_STATE = 89
CMD_GET_IMAGE_MASK_STATE = 90
CMD_MASK_UPDATE_POLYGON = 91
CMD_OPEN_DIALOG = 92

STATUS_OK = 0
STATUS_NONE = 1
STATUS_ERROR = 0xFF

# CommandStatus codes (sirilpy enums: CMD_OK=0, CMD_GENERIC_ERROR=1<<7)
CMD_OK = 0
CMD_GENERIC_ERROR = 1 << 7

_SHM_INFO = struct.Struct("@Niiii256s")   # native _SharedMemoryInfo


def _pack_shm_info(size: int, data_type: int, width: int, height: int,
                   channels: int, name: str) -> bytes:
    return _SHM_INFO.pack(size, data_type, width, height, channels,
                          name.encode())


def _seq_bitpix(seq) -> int:
    """The BITPIX of a sequence's first file, as the JAX package's
    sequence keeps it (``bitpix``, 0 for other kinds of sequence)."""
    path = seq.frame_path(0) if seq.number else None
    if not path:
        return 0
    from siril_tpu_torch.io.fits_io import image_hdus

    hdus = [h for h in image_hdus(path) if len(h.naxes) >= 2]
    return int(hdus[0].bitpix) if hdus else 0


class PythonCommandServer:
    """AF_UNIX server accepting reference-sirilpy connections."""

    def __init__(self, session=None, socket_path: Optional[str] = None):
        from siril_tpu_torch.pythonmodule.connection import SirilInterface

        self.iface = SirilInterface(session)
        self.socket_path = socket_path or os.path.join(
            os.environ.get("XDG_RUNTIME_DIR", "/tmp"),
            f"siril_tpu_torch_{os.getpid()}.sock")
        self._srv: Optional[socket.socket] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._shm: Dict[str, shared_memory.SharedMemory] = {}
        self._counter = 0

    # ------------------------------------------------------------------
    def start(self) -> str:
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)
        self._srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._srv.bind(self.socket_path)
        self._srv.listen(4)
        self._srv.settimeout(0.25)
        self._stop.clear()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True)
        self._thread.start()
        return self.socket_path

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=3.0)
        if self._srv:
            self._srv.close()
            self._srv = None
        for shm in list(self._shm.values()):
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass
        self._shm.clear()
        try:
            os.unlink(self.socket_path)
        except OSError:
            pass

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.stop()

    # ------------------------------------------------------------------
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(target=self._serve, args=(conn,),
                                 daemon=True)
            t.start()

    def _serve(self, conn: socket.socket):
        conn.settimeout(None)
        try:
            while not self._stop.is_set():
                hdr = self._recv_exact(conn, 5)
                if hdr is None:
                    return
                cmd, length = struct.unpack("!Bi", hdr)
                payload = b""
                if length > 0:
                    payload = self._recv_exact(conn, length)
                    if payload is None:
                        return
                try:
                    status, data = self._dispatch(cmd, payload)
                except Exception as e:  # handler fault → protocol error
                    status, data = STATUS_ERROR, str(e).encode()
                conn.sendall(struct.pack("!BI", status, len(data)) + data)
        finally:
            conn.close()

    @staticmethod
    def _recv_exact(conn, n: int) -> Optional[bytes]:
        buf = b""
        while len(buf) < n:
            chunk = conn.recv(n - len(buf))
            if not chunk:
                return None
            buf += chunk
        return buf

    # ------------------------------------------------------------------
    def _new_shm(self, size: int) -> shared_memory.SharedMemory:
        self._counter += 1
        name = f"siril_tpu_torch_{os.getpid()}_{self._counter}"
        shm = shared_memory.SharedMemory(name=name, create=True, size=size)
        self._shm[name] = shm
        return shm

    def _release_shm(self, name: str) -> None:
        shm = self._shm.pop(name.lstrip("/"), None)
        if shm is not None:
            try:
                shm.close()
                shm.unlink()
            except Exception:
                pass

    # ------------------------------------------------------------------
    def _dispatch(self, cmd: int, payload: bytes):
        fn = self._HANDLERS.get(cmd)
        if fn is None:
            return STATUS_ERROR, b"not implemented"
        return fn(self, payload)

    # ---- handlers ----
    def _h_send_command(self, payload):
        try:
            self.iface.cmd(*payload.decode("utf-8").split())
            code = CMD_OK
        except Exception as e:
            _log.error("python command failed: %s", e)
            code = CMD_GENERIC_ERROR
        return STATUS_OK, struct.pack("!i", code)

    def _h_log(self, payload):
        # first byte is the LogColor
        msg = payload[1:].decode("utf-8", "replace").rstrip("\n")
        self.iface.log(msg)
        return STATUS_OK, b""

    def _h_progress(self, payload):
        return STATUS_OK, b""

    def _h_wd(self, payload):
        return STATUS_OK, os.path.abspath(self.iface.ctx.cwd).encode() + b"\0"

    def _h_filename(self, payload):
        name = self.iface.get_image_filename()
        if not name:
            return STATUS_NONE, b""
        return STATUS_OK, name.encode() + b"\0"

    def _h_dims(self, payload):
        if not self.iface.is_image_loaded():
            return STATUS_NONE, b""
        c, h, w = self.iface.get_image_shape()
        return STATUS_OK, struct.pack("!III", w, h, c)

    def _h_get_pixeldata(self, payload):
        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        img = self.iface.ctx.image
        data = img.host()
        region = None
        if len(payload) >= 2 + 16:
            x, y, w, h = struct.unpack("!IIII", payload[2:18])
            region = (x, y, w, h)
        preview = len(payload) >= 1 and payload[0:1] == b"\x01"
        if region:
            x, y, w, h = region
            data = data[:, y:y + h, x:x + w]
        c, h, w = data.shape
        if preview:
            arr = np.clip(data * 255.0, 0, 255).astype(np.uint8)
            dtype_code = 0
        else:
            arr = np.ascontiguousarray(data, np.float32)
            dtype_code = 1
        shm = self._new_shm(arr.nbytes)
        shm.buf[:arr.nbytes] = arr.tobytes()
        return STATUS_OK, _pack_shm_info(arr.nbytes, dtype_code, w, h, c,
                                         shm.name)

    def _h_release_shm(self, payload):
        # payload = native _SharedMemoryInfo; the name is the last 256 B
        if len(payload) >= 256:
            name = payload[-256:].split(b"\0")[0].decode("utf-8", "replace")
            self._release_shm(name)
        return STATUS_OK, b""

    def _h_request_shm(self, payload):
        (size,) = struct.unpack("!Q", payload)
        shm = self._new_shm(int(size))
        return STATUS_OK, _pack_shm_info(int(size), 1, 0, 0, 0, shm.name)

    def _h_set_pixeldata(self, payload):
        width, height, channels, dtype_code, size, name = struct.unpack(
            "!IIIIQ256s", payload)
        name = name.split(b"\0")[0].decode("utf-8", "replace").lstrip("/")
        shm = self._shm.get(name)
        opened_here = False
        if shm is None:
            shm = shared_memory.SharedMemory(name=name)
            opened_here = True
        try:
            dtype = np.float32 if dtype_code == 1 else np.uint16
            arr = np.frombuffer(bytes(shm.buf[:size]), dtype=dtype)
            arr = arr.reshape((channels, height, width) if channels > 1
                              else (height, width))
            if arr.ndim == 2:
                arr = arr[None]
            if dtype == np.uint16:
                arr = arr.astype(np.float32) / 65535.0
            self.iface.set_image_pixeldata(np.ascontiguousarray(arr))
        finally:
            if opened_here:
                shm.close()
        return STATUS_OK, b""

    def _h_stats(self, payload):
        (channel,) = struct.unpack("!I", payload)
        st = self.iface.get_image_stats(int(channel))
        return STATUS_OK, struct.pack(
            "!2q12d", int(st.total), int(st.ngoodpix), st.mean, st.median,
            st.sigma, st.avgdev, st.mad, st.sqrtbwmv,
            getattr(st, "location", 0.0), getattr(st, "scale", 0.0),
            st.min, st.max, getattr(st, "normvalue", 1.0),
            getattr(st, "bgnoise", 0.0))

    def _h_is_image(self, payload):
        return STATUS_OK, struct.pack(
            "!i", 1 if self.iface.is_image_loaded() else 0)

    def _h_is_seq(self, payload):
        return STATUS_OK, struct.pack(
            "!i", 1 if self.iface.is_sequence_loaded() else 0)

    def _h_get_selection(self, payload):
        sel = self.iface.get_selection()
        if not sel:
            return STATUS_NONE, b""
        x, y, w, h = sel
        return STATUS_OK, struct.pack("!IIII", int(x), int(y), int(w), int(h))

    def _h_set_selection(self, payload):
        x, y, w, h = struct.unpack("!IIII", payload)
        self.iface.set_selection(x, y, w, h)
        return STATUS_OK, b""

    def _h_pix2wcs(self, payload):
        x, y = struct.unpack("!2d", payload)
        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        if not self.iface.has_wcs():
            return STATUS_ERROR, b"image is not plate solved"
        ra, dec = self.iface.pix2radec(x, y)
        return STATUS_OK, struct.pack("!2d", ra, dec)

    def _h_wcs2pix(self, payload):
        ra, dec = struct.unpack("!2d", payload)
        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        if not self.iface.has_wcs():
            return STATUS_ERROR, b"image is not plate solved"
        x, y = self.iface.radec2pix(ra, dec)
        return STATUS_OK, struct.pack("!2d", x, y)

    def _h_undo_save(self, payload):
        self.iface.undo_save_state(payload.decode("utf-8", "replace")
                                   .rstrip("\0") or "python script")
        return STATUS_OK, b""

    def _h_claim(self, payload):
        # single-process engine: the processing thread is free unless a
        # job is running (processing_thread.c:527 semantics)
        return STATUS_OK, b""

    def _h_release(self, payload):
        return STATUS_OK, b""

    def _shm_bytes(self, data: bytes, data_type=0, w=0, h=0, c=0):
        """Put ``data`` in a fresh shm segment, reply with the NATIVE
        _SharedMemoryInfo struct (client ctypes-parses it)."""
        shm = self._new_shm(max(len(data), 1))
        shm.buf[:len(data)] = data
        return STATUS_OK, _pack_shm_info(len(data), data_type, w, h, c,
                                         shm.name)

    def _client_shm(self, name: str, size: int) -> bytes:
        """Read back a segment the client filled (REQUEST_SHM flow),
        then free it — some client setters never send RELEASE_SHM for
        their own segments (e.g. set_image_iccprofile, xy_plot); the
        reference C side frees after consuming, and a late RELEASE_SHM
        from the client is a harmless no-op."""
        name = name.split("\0")[0] if isinstance(name, str) else name
        key = name.lstrip("/")
        shm = self._shm.get(key)
        opened = False
        if shm is None:
            shm = shared_memory.SharedMemory(name=key)
            opened = True
        try:
            return bytes(shm.buf[:size])
        finally:
            if opened:
                shm.close()
            else:
                self._release_shm(key)

    @staticmethod
    def _info_struct(payload):
        """'!IIIIQ256s' info block → (a, b, c, d, size, name)."""
        a, b, c, d, size, name = struct.unpack("!IIIIQ256s", payload)
        return a, b, c, d, size, name.split(b"\0")[0].decode(
            "utf-8", "replace")

    def _h_header(self, payload):
        hdr = self.iface.get_image_header()
        if not hdr:
            return STATUS_NONE, b""
        return self._shm_bytes(hdr.encode() + b"\0")

    def _h_history(self, payload):
        hist = self.iface.get_image_history()
        if not hist:
            return STATUS_NONE, b""
        return self._shm_bytes(("\n".join(hist)).encode() + b"\0")

    def _h_unknown_keys(self, payload):
        keys = self.iface.get_image_unknown_keys()
        if not keys:
            return STATUS_NONE, b""
        return self._shm_bytes(keys.encode() + b"\0")

    def _h_siril_log(self, payload):
        lines = self.iface.get_siril_log()
        if not lines:
            return STATUS_NONE, b""
        return self._shm_bytes(("\n".join(lines)).encode() + b"\0")

    def _h_icc_profile(self, payload):
        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        icc = self.iface.get_image_iccprofile()
        if not icc:
            return STATUS_NONE, b""
        return self._shm_bytes(icc)

    def _h_display_icc(self, payload):
        icc = self.iface.get_siril_display_iccprofile()
        if not icc:
            return STATUS_NONE, b""
        return self._shm_bytes(icc)

    def _h_keywords(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_keywords

        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        return STATUS_OK, pack_keywords(self.iface.ctx.image)

    def _h_get_image(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_core_ffit

        if not self.iface.is_image_loaded():
            return STATUS_NONE, b""
        return STATUS_OK, pack_core_ffit(self.iface.ctx.image)

    def _h_psfstars(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_psfstar

        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        stars = self.iface.get_image_stars()
        if not stars:
            return STATUS_NONE, b""
        return self._shm_bytes(b"".join(pack_psfstar(s) for s in stars))

    def _h_seq_stats(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_stats

        frame, channel = struct.unpack("!II", payload)
        st = self.iface.get_seq_stats(int(frame), int(channel))
        if st is None:
            return STATUS_NONE, b""
        return STATUS_OK, pack_stats(st)

    def _h_seq_regdata(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_regdata

        frame, channel = struct.unpack("!II", payload)
        r = self.iface.get_seq_regdata(int(frame), int(channel))
        if r is None:
            return STATUS_NONE, b""
        return STATUS_OK, pack_regdata(r)

    def _h_seq_imgdata(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_imgdata

        (frame,) = struct.unpack("!I", payload)
        d = self.iface.get_seq_imgdata(int(frame))
        if d is None:
            return STATUS_NONE, b""
        return STATUS_OK, pack_imgdata(d)

    def _h_seq_distodata(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import DISTO_FORMAT

        (channel,) = struct.unpack("!I", payload)
        d = self.iface.get_seq_distodata(int(channel))
        vel = d.get("velocity", (0.0, 0.0)) if d else (0.0, 0.0)
        body = struct.pack(DISTO_FORMAT, int(d.get("index", 0)) if d else 0,
                           float(vel[0]), float(vel[1]))
        fname = (d.get("filename") or "") if d else ""
        return STATUS_OK, body + fname.encode() + b"\0"

    def _h_get_seq(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import SEQ_FORMAT

        if not self.iface.is_sequence_loaded():
            return STATUS_NONE, b""
        seq = self.iface.ctx.sequence
        body = struct.pack(
            SEQ_FORMAT, int(seq.number), int(seq.selnum),
            int(getattr(seq, "fixed_len", 5)), int(max(seq.nb_layers, 1)),
            int(seq.rx), int(seq.ry),
            1 if getattr(seq, "is_variable", False) else 0,
            _seq_bitpix(seq),
            int(getattr(seq, "reference_image", -1)),
            int(getattr(seq, "beg", 0)), int(getattr(seq, "end", 0)),
            float(getattr(seq, "exposure", 0.0)),
            1 if getattr(seq, "fz", False) else 0,
            int(getattr(seq, "seq_type", 0) or 0),
            1 if getattr(seq, "cfa_opened_monochrome", False) else 0,
            int(getattr(seq, "current", -1)))
        return STATUS_OK, body + seq.name.encode() + b"\0"

    def _h_seq_pixeldata(self, payload):
        preview = payload[0:1] == b"\x01"
        (frame,) = struct.unpack("!I", payload[2:6])
        region = None
        if len(payload) >= 6 + 16:
            region = struct.unpack("!IIII", payload[6:22])
        img = self.iface.get_seq_frame(int(frame))
        if img is None:
            return STATUS_ERROR, b"no sequence loaded"
        data = img.host()
        if region:
            x, y, w, h = region
            data = data[:, y:y + h, x:x + w]
        return self._pixeldata_shm(data, preview)

    def _pixeldata_shm(self, data, preview):
        c, h, w = data.shape
        if preview:
            arr = np.clip(data * 255.0, 0, 255).astype(np.uint8)
            dtype_code = 0
        else:
            arr = np.ascontiguousarray(data, np.float32)
            dtype_code = 1
        shm = self._new_shm(arr.nbytes)
        shm.buf[:arr.nbytes] = arr.tobytes()
        return STATUS_OK, _pack_shm_info(arr.nbytes, dtype_code, w, h, c,
                                         shm.name)

    def _net_shm_for(self, data: bytes, dtype=0, w=0, h=0, c=0) -> bytes:
        """Fill a segment, return the NETWORK-order shm info block."""
        from siril_tpu_torch.pythonmodule.wire_formats import NET_SHM_INFO

        shm = self._new_shm(max(len(data), 1))
        shm.buf[:len(data)] = data
        return struct.pack(NET_SHM_INFO, len(data), dtype, w, h, c,
                           shm.name.encode())

    def _h_get_seq_image(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import (
            NET_SHM_INFO,
            pack_core_ffit,
            pack_keywords,
        )

        frame, with_pixels, preview, linked = struct.unpack(
            "!I???", payload)
        img = self.iface.get_seq_frame(int(frame))
        if img is None:
            return STATUS_ERROR, b"no sequence loaded"
        body = pack_core_ffit(img) + pack_keywords(img)
        if with_pixels:
            data = img.host()
            c, h, w = data.shape
            if preview:
                arr = np.clip(data * 255.0, 0, 255).astype(np.uint8)
                body += self._net_shm_for(arr.tobytes(), 0, w, h, c)
            else:
                arr = np.ascontiguousarray(data, np.float32)
                body += self._net_shm_for(arr.tobytes(), 1, w, h, c)
        hdr = self.iface.get_seq_frame_header(int(frame)) or ""
        if hdr:
            body += self._net_shm_for(hdr.encode() + b"\0")
        else:
            body += struct.pack(NET_SHM_INFO, 0, 0, 0, 0, 0, b"")
        icc = img.icc_profile if getattr(img, "icc_profile", None) else None
        if icc:
            body += self._net_shm_for(icc)
        else:
            body += struct.pack(NET_SHM_INFO, 0, 0, 0, 0, 0, b"")
        return STATUS_OK, body

    def _h_get_image_file(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import (
            NET_SHM_INFO,
            pack_core_ffit,
            pack_keywords,
            stats14,
        )

        with_pixels, preview, linked = struct.unpack("!???", payload[:3])
        path = payload[3:].split(b"\0")[0].decode("utf-8")
        img = self.iface.load_image_from_file(path)
        body = pack_core_ffit(img) + pack_keywords(img)
        from siril_tpu_torch.ops.statistics import STATS_MAIN, compute_stats_np

        data = img.host()
        for c in range(3):
            st = compute_stats_np(data[c], STATS_MAIN) \
                if c < data.shape[0] else None
            body += struct.pack("!14d", *stats14(st))
        if with_pixels:
            c, h, w = data.shape
            if preview:
                arr = np.clip(data * 255.0, 0, 255).astype(np.uint8)
                body += self._net_shm_for(arr.tobytes(), 0, w, h, c)
            else:
                arr = np.ascontiguousarray(data, np.float32)
                body += self._net_shm_for(arr.tobytes(), 1, w, h, c)
        else:
            body += struct.pack(NET_SHM_INFO, 0, 0, 0, 0, 0, b"")
        hdr = "" if img.fits_header is None else img.fits_header.text()
        if hdr:
            body += self._net_shm_for(hdr.encode() + b"\0")
        else:
            body += struct.pack(NET_SHM_INFO, 0, 0, 0, 0, 0, b"")
        body += struct.pack(NET_SHM_INFO, 0, 0, 0, 0, 0, b"")  # icc
        return STATUS_OK, body

    def _h_analyse_file(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_analysis

        path = payload.split(b"\0")[0].decode("utf-8")
        return STATUS_OK, pack_analysis(
            self.iface.analyse_image_from_file(path))

    def _h_get_config(self, payload):
        parts = payload.split(b"\0")
        group = parts[0].decode("utf-8") if parts else ""
        key = parts[1].decode("utf-8") if len(parts) > 1 else ""
        val = self.iface.get_siril_config(group, key)
        if val is None:
            return STATUS_NONE, b""
        if isinstance(val, bool):
            return STATUS_OK, bytes([0]) + struct.pack("!I", int(val))
        if isinstance(val, int):
            return STATUS_OK, bytes([1]) + struct.pack("!i", val)
        if isinstance(val, float):
            return STATUS_OK, bytes([2]) + struct.pack("!d", val)
        if isinstance(val, (list, tuple)):
            return STATUS_OK, bytes([5]) + b"".join(
                str(v).encode() + b"\0" for v in val)
        return STATUS_OK, bytes([3]) + str(val).encode() + b"\0"

    def _h_active_vport(self, payload):
        return STATUS_OK, struct.pack(
            "!I", int(self.iface.get_siril_active_vport()))

    def _h_star_in_selection(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_psfstar

        x, y, w, h, channel, centred = struct.unpack("!IIIIII", payload)
        SENT = 0xFFFFFFFF
        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        if x != SENT:
            self.iface.set_selection(int(x), int(y), int(w), int(h))
        star = self.iface.get_selection_star(
            None if channel == SENT else int(channel))
        if star is None:
            return STATUS_NONE, b""
        return STATUS_OK, pack_psfstar(star)

    def _h_stats_for_selection(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_stats

        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        channel = 0
        if len(payload) >= 16:
            x, y, w, h = struct.unpack("!IIII", payload[:16])
            self.iface.set_selection(int(x), int(y), int(w), int(h))
            if len(payload) >= 20:
                (channel,) = struct.unpack("!I", payload[16:20])
        elif len(payload) >= 4:
            (channel,) = struct.unpack("!I", payload[:4])
        st = self.iface.get_selection_stats(int(channel))
        if st is None:
            return STATUS_NONE, b""
        return STATUS_OK, pack_stats(st)

    def _h_bundle_path(self, payload):
        import sys

        return STATUS_OK, os.path.dirname(sys.executable).encode() + b"\0"

    def _h_error_messagebox(self, payload):
        self.iface.error_messagebox(
            payload.split(b"\0")[0].decode("utf-8", "replace"))
        return STATUS_OK, b""

    def _h_info_messagebox(self, payload):
        self.iface.info_messagebox(
            payload.split(b"\0")[0].decode("utf-8", "replace"))
        return STATUS_OK, b""

    def _h_warning_messagebox(self, payload):
        self.iface.warning_messagebox(
            payload.split(b"\0")[0].decode("utf-8", "replace"))
        return STATUS_OK, b""

    def _h_confirm_messagebox(self, payload):
        parts = payload.split(b"\0")
        title = parts[0].decode("utf-8", "replace") if parts else ""
        message = parts[1].decode("utf-8", "replace") if len(parts) > 1 \
            else ""
        label = parts[2].decode("utf-8", "replace") if len(parts) > 2 \
            else "OK"
        ok = self.iface.confirm_messagebox(title, message, label)
        # client reads little-endian int
        return STATUS_OK, struct.pack("<i", 1 if ok else 0)

    def _h_plot(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import (
            deserialize_plotdata,
        )

        save, display, _, _, size, name = self._info_struct(payload)
        pd = deserialize_plotdata(self._client_shm(name, size))
        self.iface.xy_plot(pd)
        return STATUS_OK, b""

    def _h_seq_frame_set_pixeldata(self, payload):
        (index,) = struct.unpack("!i", payload[:4])
        w, h, c, dtype_code, size, name = self._info_struct(
            payload[4:4 + struct.calcsize("!IIIIQ256s")])
        prefix = payload[4 + struct.calcsize("!IIIIQ256s"):].split(
            b"\0")[0].decode("utf-8")
        buf = self._client_shm(name, size)
        dtype = np.float32 if dtype_code == 1 else np.uint16
        arr = np.frombuffer(buf, dtype=dtype).reshape((c, h, w) if c > 1
                                                      else (h, w))
        if arr.ndim == 2:
            arr = arr[None]
        if dtype == np.uint16:
            arr = arr.astype(np.float32) / 65535.0
        self.iface.set_seq_frame_pixeldata(
            int(index), np.ascontiguousarray(arr, np.float32),
            prefix=prefix or None)
        return STATUS_OK, b""

    def _h_get_bgsamples(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import pack_bgsample

        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        samples = self.iface.get_image_bgsamples()
        if not samples:
            return STATUS_NONE, b""
        return self._shm_bytes(b"".join(pack_bgsample(s)
                                        for s in samples))

    def _h_set_bgsamples(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import (
            unpack_native_bgsamples,
        )

        _, _, recalc, show, size, name = self._info_struct(payload)
        samples = unpack_native_bgsamples(self._client_shm(name, size))
        self.iface.set_image_bgsamples(samples, show_samples=bool(show),
                                       recalculate=bool(recalc))
        return STATUS_OK, b""

    def _h_clear_bgsamples(self, payload):
        self.iface.clear_image_bgsamples()
        return STATUS_OK, b""

    def _h_set_image_header(self, payload):
        _, _, _, _, size, name = self._info_struct(payload)
        header = self._client_shm(name, size).split(b"\0")[0].decode(
            "utf-8", "replace")
        self.iface.set_image_metadata_from_header_string(header)
        return STATUS_OK, b""

    def _h_add_polygon(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import (
            deserialize_polygon,
        )

        _, _, _, _, size, name = self._info_struct(payload)
        poly, _rest = deserialize_polygon(self._client_shm(name, size))
        self.iface.overlay_add_polygon(poly)
        return STATUS_OK, struct.pack("!i", int(poly["polygon_id"]))

    def _h_delete_polygon(self, payload):
        (pid,) = struct.unpack("!i", payload[:4])
        self.iface.overlay_delete_polygon(int(pid))
        return STATUS_OK, b""

    def _h_clear_polygons(self, payload):
        self.iface.overlay_clear_polygons()
        return STATUS_OK, b""

    def _h_get_polygon(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import serialize_polygon

        (pid,) = struct.unpack("!i", payload[:4])
        poly = self.iface.overlay_get_polygon(int(pid))
        if poly is None:
            return STATUS_NONE, b""
        return self._shm_bytes(serialize_polygon(poly))

    def _h_get_polygon_list(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import serialize_polygon

        polys = self.iface.overlay_get_polygons_list()
        if not polys:
            return STATUS_NONE, b""
        body = struct.pack("!I", len(polys)) + b"".join(
            serialize_polygon(p) for p in polys)
        return self._shm_bytes(body)

    def _h_draw_polygon(self, payload):
        return STATUS_ERROR, b"headless: interactive drawing unavailable"

    def _h_open_dialog(self, payload):
        return STATUS_ERROR, b"headless: no GUI dialogs"

    def _h_mask_update_polygon(self, payload):
        from siril_tpu_torch.pythonmodule.wire_formats import (
            deserialize_polygon,
        )

        adding, _, _, _, size, name = self._info_struct(payload)
        poly, _rest = deserialize_polygon(self._client_shm(name, size))
        if adding:
            self.iface.mask_add_polygon(poly["points"])
        else:
            self.iface.mask_subtract_polygon(poly["points"])
        return STATUS_OK, b""

    def _h_create_new_seq(self, payload):
        import glob
        import re

        root = payload.split(b"\0")[0].decode("utf-8")
        if root.endswith(".ext"):
            root = root[:-4]
        cwd = self.iface.ctx.cwd
        files = sorted(
            f for f in glob.glob(os.path.join(cwd, root + "*"))
            if re.match(rf"^{re.escape(root)}\d{{5}}\.\w+$",
                        os.path.basename(f)))
        if not files:
            return STATUS_ERROR, b"no matching files"
        self.iface.create_new_seq(root, files)
        return STATUS_OK, b""

    def _h_seq_frame_header(self, payload):
        (frame,) = struct.unpack("!I", payload[:4])
        hdr = self.iface.get_seq_frame_header(int(frame))
        if not hdr:
            return STATUS_NONE, b""
        return self._shm_bytes(hdr.encode() + b"\0")

    def _h_seq_frame_filename(self, payload):
        (frame,) = struct.unpack("!I", payload[:4])
        name = self.iface.get_seq_frame_filename(int(frame))
        if not name:
            return STATUS_NONE, b""
        return STATUS_OK, name.encode() + b"\0"

    def _h_set_image_iccprofile(self, payload):
        _, _, _, _, size, name = self._info_struct(payload)
        self.iface.set_image_iccprofile(self._client_shm(name, size))
        return STATUS_OK, b""

    def _h_clear_undo_history(self, payload):
        self.iface.clear_undo_history()
        return STATUS_OK, b""

    def _h_redo(self, payload):
        self.iface.redo()
        return STATUS_OK, b""

    def _h_slider_state(self, payload):
        lo, hi, mode = self.iface.get_siril_slider_state()
        return STATUS_OK, struct.pack("!HHI", int(lo), int(hi),
                                      int(mode))

    def _h_set_slider_mode(self, payload):
        (mode,) = struct.unpack("!I", payload[:4])
        self.iface.set_siril_slider_mode(int(mode))
        return STATUS_OK, b""

    def _h_set_slider_lohi(self, payload):
        lo, hi = struct.unpack("!II", payload[:8])
        self.iface.set_siril_slider_lohi(int(lo), int(hi))
        return STATUS_OK, b""

    def _h_get_stfmode(self, payload):
        return STATUS_OK, struct.pack("!I", int(self.iface.get_siril_stf()))

    def _h_set_stfmode(self, payload):
        (mode,) = struct.unpack("!I", payload[:4])
        self.iface.set_siril_stf(int(mode))
        return STATUS_OK, b""

    def _h_get_panzoom(self, payload):
        x, y, zoom = self.iface.get_siril_panzoom()
        return STATUS_OK, struct.pack("!ddd", float(x), float(y),
                                      float(zoom))

    def _h_set_pan(self, payload):
        x, y = struct.unpack("!dd", payload[:16])
        self.iface.set_siril_pan(x, y)
        return STATUS_OK, b""

    def _h_set_zoom(self, payload):
        (zoom,) = struct.unpack("!d", payload[:8])
        self.iface.set_siril_zoom(zoom)
        return STATUS_OK, b""

    def _h_get_stf_linked(self, payload):
        return STATUS_OK, struct.pack(
            "!I", 1 if self.iface.get_siril_stf_linked() else 0)

    def _h_set_stf_linked(self, payload):
        self.iface.set_siril_stf_linked(payload[0:1] == b"\x01")
        return STATUS_OK, b""

    def _h_set_image_filename(self, payload):
        self.iface.set_image_filename(
            payload.split(b"\0")[0].decode("utf-8"))
        return STATUS_OK, b""

    def _h_save_image_file(self, payload):
        w, h, c, dtype_code, img_size, img_name = self._info_struct(
            payload[:struct.calcsize("!IIIIQ256s")])
        rest = payload[struct.calcsize("!IIIIQ256s"):]
        hdr_size, hdr_name = struct.unpack("!Q256s", rest[:264])
        hdr_name = hdr_name.split(b"\0")[0].decode("utf-8", "replace")
        filename = rest[264:264 + 256].split(b"\0")[0].decode("utf-8")
        dtype = np.float32 if dtype_code == 1 else np.uint16
        arr = np.frombuffer(self._client_shm(img_name, img_size),
                            dtype=dtype)
        arr = arr.reshape((c, h, w) if c > 1 else (h, w))
        if arr.ndim == 2:
            arr = arr[None]
        if dtype == np.uint16:
            arr = arr.astype(np.float32) / 65535.0
        header = self._client_shm(hdr_name, int(hdr_size)).split(
            b"\0")[0].decode("utf-8", "replace")
        from siril_tpu_torch.core.image import SirilImage

        img = SirilImage(data=np.ascontiguousarray(arr, np.float32))
        self.iface.save_image_file(img, filename, header=header)
        return STATUS_OK, b""

    def _h_get_image_mask(self, payload):
        if not self.iface.is_image_loaded():
            return STATUS_ERROR, b"no image loaded"
        mask = self.iface.get_image_mask()
        if mask is None:
            return STATUS_NONE, b""
        mask = np.ascontiguousarray(mask)
        bitpix = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16}.get(
            mask.dtype, 32)
        if bitpix == 32:
            mask = mask.astype(np.float32)
        h, w = mask.shape
        return self._shm_bytes(mask.tobytes(), bitpix, w, h, 1)

    def _h_set_image_mask(self, payload):
        w, h, c, bitpix, size, name = self._info_struct(payload)
        dtype = {8: np.uint8, 16: np.uint16}.get(int(bitpix), np.float32)
        arr = np.frombuffer(self._client_shm(name, size),
                            dtype=dtype).reshape(h, w)
        if dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        elif dtype == np.uint16:
            arr = arr.astype(np.float32) / 65535.0
        self.iface.set_image_mask(np.ascontiguousarray(arr, np.float32))
        return STATUS_OK, b""

    def _h_set_mask_state(self, payload):
        self.iface.set_image_mask_state(payload[0:1] == b"\x01")
        return STATUS_OK, b""

    def _h_get_mask_state(self, payload):
        if self.iface.get_image_mask() is None:
            return STATUS_NONE, b""
        return STATUS_OK, struct.pack(
            "!I", 1 if self.iface.get_image_mask_state() else 0)

    def _h_userconfig_dir(self, payload):
        base = os.environ.get("XDG_CONFIG_HOME",
                              os.path.expanduser("~/.config"))
        return STATUS_OK, base.encode() + b"\0"

    def _h_userdata_dir(self, payload):
        base = os.environ.get("XDG_DATA_HOME",
                              os.path.expanduser("~/.local/share"))
        return STATUS_OK, base.encode() + b"\0"

    def _h_none(self, payload):
        return STATUS_NONE, b""

    def _h_set_seq_frame_incl(self, payload):
        frame, incl = struct.unpack("!Ii", payload[:8])
        self.iface.set_seq_frame_incl(int(frame), bool(incl))
        return STATUS_OK, b""

    def _h_undo(self, payload):
        self.iface.undo()
        return STATUS_OK, b""

    _HANDLERS = {
        CMD_SEND_COMMAND: _h_send_command,
        CMD_LOG_MESSAGE: _h_log,
        CMD_UPDATE_PROGRESS: _h_progress,
        CMD_GET_WORKING_DIRECTORY: _h_wd,
        CMD_GET_FILENAME: _h_filename,
        CMD_GET_DIMENSIONS: _h_dims,
        CMD_GET_PIXELDATA: _h_get_pixeldata,
        CMD_GET_PIXELDATA_REGION: _h_get_pixeldata,
        CMD_RELEASE_SHM: _h_release_shm,
        CMD_SET_PIXELDATA: _h_set_pixeldata,
        CMD_GET_IMAGE_STATS: _h_stats,
        CMD_GET_KEYWORDS: _h_keywords,
        CMD_GET_ICC_PROFILE: _h_icc_profile,
        CMD_GET_FITS_HEADER: _h_header,
        CMD_GET_FITS_HISTORY: _h_history,
        CMD_GET_FITS_UNKNOWN_KEYS: _h_unknown_keys,
        CMD_GET_IMAGE: _h_get_image,
        CMD_GET_PSFSTARS: _h_psfstars,
        CMD_GET_SEQ_STATS: _h_seq_stats,
        CMD_GET_SEQ_REGDATA: _h_seq_regdata,
        CMD_GET_SEQ_IMGDATA: _h_seq_imgdata,
        CMD_GET_SEQ_PIXELDATA: _h_seq_pixeldata,
        CMD_GET_SEQ_IMAGE: _h_get_seq_image,
        CMD_GET_SEQ: _h_get_seq,
        CMD_GET_CONFIG: _h_get_config,
        CMD_GET_USERCONFIG_DIR: _h_userconfig_dir,
        CMD_GET_IS_IMAGE_LOADED: _h_is_image,
        CMD_GET_IS_SEQUENCE_LOADED: _h_is_seq,
        CMD_GET_SELECTION: _h_get_selection,
        CMD_SET_SELECTION: _h_set_selection,
        CMD_GET_ACTIVE_VPORT: _h_active_vport,
        CMD_GET_STAR_IN_SELECTION: _h_star_in_selection,
        CMD_GET_STATS_FOR_SELECTION: _h_stats_for_selection,
        CMD_PIX2WCS: _h_pix2wcs,
        CMD_WCS2PIX: _h_wcs2pix,
        CMD_UNDO_SAVE_STATE: _h_undo_save,
        CMD_GET_BUNDLE_PATH: _h_bundle_path,
        CMD_ERROR_MESSAGEBOX: _h_error_messagebox,
        CMD_ERROR_MESSAGEBOX_MODAL: _h_error_messagebox,
        CMD_SIRIL_PLOT: _h_plot,
        CMD_CLAIM_THREAD: _h_claim,
        CMD_RELEASE_THREAD: _h_release,
        CMD_SEQ_FRAME_SET_PIXELDATA: _h_seq_frame_set_pixeldata,
        CMD_REQUEST_SHM: _h_request_shm,
        CMD_SET_SEQ_FRAME_INCL: _h_set_seq_frame_incl,
        CMD_GET_USERDATA_DIR: _h_userdata_dir,
        CMD_GET_SYSTEMDATA_DIR: _h_userdata_dir,
        CMD_GET_BGSAMPLES: _h_get_bgsamples,
        CMD_SET_BGSAMPLES: _h_set_bgsamples,
        CMD_GET_SEQ_FRAME_FILENAME: _h_seq_frame_filename,
        CMD_INFO_MESSAGEBOX: _h_info_messagebox,
        CMD_INFO_MESSAGEBOX_MODAL: _h_info_messagebox,
        CMD_WARNING_MESSAGEBOX: _h_warning_messagebox,
        CMD_WARNING_MESSAGEBOX_MODAL: _h_warning_messagebox,
        CMD_GET_SEQ_DISTODATA: _h_seq_distodata,
        CMD_SET_IMAGE_HEADER: _h_set_image_header,
        CMD_ADD_USER_POLYGON: _h_add_polygon,
        CMD_DELETE_USER_POLYGON: _h_delete_polygon,
        CMD_CLEAR_USER_POLYGONS: _h_clear_polygons,
        CMD_GET_USER_POLYGON: _h_get_polygon,
        CMD_GET_USER_POLYGON_LIST: _h_get_polygon_list,
        CMD_CONFIRM_MESSAGEBOX: _h_confirm_messagebox,
        CMD_GET_SEQ_FRAME_HEADER: _h_seq_frame_header,
        CMD_CREATE_NEW_SEQ: _h_create_new_seq,
        CMD_CLEAR_BGSAMPLES: _h_clear_bgsamples,
        CMD_DRAW_POLYGON: _h_draw_polygon,
        CMD_GET_IMAGE_FILE: _h_get_image_file,
        CMD_ANALYSE_IMAGE_FROM_FILE: _h_analyse_file,
        CMD_UNDO: _h_undo,
        CMD_REDO: _h_redo,
        CMD_SET_IMAGE_ICCPROFILE: _h_set_image_iccprofile,
        CMD_CLEAR_UNDO_HISTORY: _h_clear_undo_history,
        CMD_GET_SLIDER_STATE: _h_slider_state,
        CMD_SET_SLIDER_MODE: _h_set_slider_mode,
        CMD_SET_SLIDER_LOHI: _h_set_slider_lohi,
        CMD_GET_STFMODE: _h_get_stfmode,
        CMD_SET_STFMODE: _h_set_stfmode,
        CMD_GET_PANZOOM: _h_get_panzoom,
        CMD_SET_PAN: _h_set_pan,
        CMD_SET_ZOOM: _h_set_zoom,
        CMD_GET_DISPLAY_ICCPROFILE: _h_display_icc,
        CMD_GET_STF_LINKED: _h_get_stf_linked,
        CMD_SET_STF_LINKED: _h_set_stf_linked,
        CMD_SET_IMAGE_FILENAME: _h_set_image_filename,
        CMD_GET_SIRIL_LOG: _h_siril_log,
        CMD_SAVE_IMAGE_FILE: _h_save_image_file,
        CMD_GET_IMAGE_MASK: _h_get_image_mask,
        CMD_SET_IMAGE_MASK: _h_set_image_mask,
        CMD_SET_IMAGE_MASK_STATE: _h_set_mask_state,
        CMD_GET_IMAGE_MASK_STATE: _h_get_mask_state,
        CMD_MASK_UPDATE_POLYGON: _h_mask_update_polygon,
        CMD_OPEN_DIALOG: _h_open_dialog,
    }


def run_python_script(script_path: str, session, args=None,
                      timeout: Optional[float] = None) -> int:
    """``pyscript`` command backend: start the wire server, spawn the
    script with $MY_SOCKET set (the reference's venv bootstrap is
    replaced by the current interpreter), wait for completion.  The
    bootstrap puts the repository's root on the path and imports only
    ``siril_tpu_torch.pythonmodule.client`` (numpy and the stdlib)."""
    import subprocess
    import sys

    with PythonCommandServer(session) as srv:
        env = dict(os.environ)
        env["MY_SOCKET"] = srv.socket_path
        # bootstrap: run the user script with a ``siril`` wire client
        # pre-injected (scripts may also ``import sirilpy`` themselves —
        # the reference package reads the same $MY_SOCKET)
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        script_dir = os.path.dirname(os.path.abspath(script_path)) or "."
        boot = (
            "import sys; sys.path.insert(0, %r)\n"
            "sys.path.insert(0, %r)\n"   # script dir: sibling imports
            "from siril_tpu_torch.pythonmodule.client import "
            "SirilWireClient\n"
            "siril = SirilWireClient()\n"
            "import builtins\n"
            "builtins.siril = siril\n"
            "sys.argv = [%r] + sys.argv[1:]\n"
            "exec(compile(open(%r, encoding='utf-8').read(), %r, 'exec'),"
            " {'siril': siril, '__name__': '__main__', '__file__': %r})\n"
            % (repo_root, script_dir, script_path, script_path, script_path,
               script_path)
        )
        proc = subprocess.run(
            [sys.executable, "-c", boot] + list(args or []),
            env=env, timeout=timeout)
        return proc.returncode
