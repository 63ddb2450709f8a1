"""sirilpy-compatible wire client — counterpart of
``siril_tpu/pythonmodule/client.py``, the script side of
``pythonmodule/server.py``.  It imports numpy and the stdlib only, so a
``pyscript`` subprocess loads neither torch nor anything else of the
port.

The reference ships this as the ``sirilpy`` pip package
(``python_module/sirilpy/connection.py``); scripts do
``siril = sirilpy.SirilInterface()`` and speak the socket+SHM protocol.
This module provides the same core surface for environments without the
reference package installed, and backs the ``pyscript`` command's injected
``siril`` global.

Protocol (siril_pythonmodule.h:15+):
  request  = ``!Bi`` (command u8, payload length) + payload
  response = ``!BI`` (status u8, payload length) + payload
Pixel data crosses in POSIX shared memory described by a native-endian
``_SharedMemoryInfo`` struct.
"""

from __future__ import annotations

import os
import socket
import struct
from multiprocessing import shared_memory
from typing import Optional, Tuple

import numpy as np

from siril_tpu_torch.pythonmodule import server as _proto

_SHM_INFO = _proto._SHM_INFO


class SirilWireError(RuntimeError):
    pass


class SirilWireClient:
    """Connects to the socket named by $MY_SOCKET (or an explicit path)."""

    def __init__(self, socket_path: Optional[str] = None):
        self.socket_path = socket_path or os.environ.get("MY_SOCKET")
        if not self.socket_path:
            raise SirilWireError("MY_SOCKET is not set")
        self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._sock.connect(self.socket_path)

    # ------------------------------------------------------------------
    def _request(self, cmd: int, payload: bytes = b"") -> Tuple[int, bytes]:
        self._sock.sendall(struct.pack("!Bi", cmd, len(payload)) + payload)
        hdr = self._recv_exact(5)
        status, length = struct.unpack("!BI", hdr)
        data = self._recv_exact(length) if length else b""
        return status, data

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self._sock.recv(n - len(buf))
            if not chunk:
                raise SirilWireError("connection closed")
            buf += chunk
        return buf

    def _check(self, status: int, data: bytes) -> bytes:
        if status == _proto.STATUS_ERROR:
            raise SirilWireError(data.decode("utf-8", "replace"))
        return data

    # ------------------------------------------------------------------
    def cmd(self, *args: str) -> None:
        """Run a Siril command (sirilpy SirilInterface.cmd)."""
        status, data = self._request(_proto.CMD_SEND_COMMAND,
                                     " ".join(str(a) for a in args).encode())
        self._check(status, data)
        if len(data) >= 4:
            (code,) = struct.unpack("!i", data[:4])
            if code != _proto.CMD_OK:
                raise SirilWireError(
                    f"command failed: {' '.join(str(a) for a in args)}")

    def log(self, message: str) -> None:
        self._request(_proto.CMD_LOG_MESSAGE, b"\x00" + message.encode())

    def get_siril_wd(self) -> str:
        _, data = self._request(_proto.CMD_GET_WORKING_DIRECTORY)
        return data.rstrip(b"\0").decode()

    def is_image_loaded(self) -> bool:
        status, data = self._request(_proto.CMD_GET_IS_IMAGE_LOADED)
        return bool(data and data[0])

    def get_image_shape(self) -> Tuple[int, int, int]:
        status, data = self._request(_proto.CMD_GET_DIMENSIONS)
        if status != _proto.STATUS_OK:
            raise SirilWireError("no image loaded")
        w, h, c = struct.unpack("!III", data)
        return c, h, w

    # ------------------------------------------------------------------
    def get_image_pixeldata(self,
                            region: Optional[Tuple[int, int, int, int]]
                            = None) -> np.ndarray:
        """Fetch the loaded image's pixels via SHM → (C,H,W) float32."""
        payload = b"\x00\x01"
        if region is not None:
            payload += struct.pack("!IIII", *region)
        status, data = self._request(_proto.CMD_GET_PIXELDATA, payload)
        self._check(status, data)
        size, dtype_code, w, h, c, name = _SHM_INFO.unpack(data)
        name = name.split(b"\0")[0].decode()
        shm = shared_memory.SharedMemory(name=name)
        try:
            dt = np.uint8 if dtype_code == 0 else np.float32
            arr = np.frombuffer(shm.buf[:size], dtype=dt).reshape(
                c, h, w).copy()
        finally:
            shm.close()
            # the name is the struct's trailing 256 bytes — echo the
            # descriptor back verbatim
            self._request(_proto.CMD_RELEASE_SHM, data)
        return arr

    def set_image_pixeldata(self, arr: np.ndarray) -> None:
        """Replace the loaded image's pixels via SHM."""
        arr = np.ascontiguousarray(arr, np.float32)
        if arr.ndim == 2:
            arr = arr[None]
        c, h, w = arr.shape
        status, data = self._request(_proto.CMD_REQUEST_SHM,
                                     struct.pack("!Q", arr.nbytes))
        self._check(status, data)
        size, _, _, _, _, name = _SHM_INFO.unpack(data)
        name = name.split(b"\0")[0].decode()
        shm = shared_memory.SharedMemory(name=name)
        try:
            shm.buf[:arr.nbytes] = arr.tobytes()
        finally:
            shm.close()
        desc = struct.pack("!IIIIQ", w, h, c, 1, arr.nbytes) + \
            name.encode().ljust(256, b"\0")
        status, sdata = self._request(_proto.CMD_SET_PIXELDATA, desc)
        self._check(status, sdata)
        # unlink the server-side segment — without this every call leaks
        # one image-sized /dev/shm block until server shutdown
        self._request(_proto.CMD_RELEASE_SHM, data)

    # ------------------------------------------------------------------
    def get_selection(self):
        status, data = self._request(_proto.CMD_GET_SELECTION)
        if status != _proto.STATUS_OK or len(data) < 16:
            return None
        return struct.unpack("!IIII", data[:16])

    def set_selection(self, x: int, y: int, w: int, h: int) -> None:
        self._request(_proto.CMD_SET_SELECTION,
                      struct.pack("!IIII", x, y, w, h))

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
