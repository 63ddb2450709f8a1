"""sirilpy-compatible scripting interface — counterpart of
``siril_tpu/pythonmodule``.

``SirilInterface`` (``connection.py``) drives a ``cli.context.Session``
in process; ``server.py`` serves the reference's socket + shared-memory
wire protocol to a script that ``pyscript`` starts, and ``client.py`` is
that script's side.  The names below load on first use, so importing
the client in a script's process loads neither torch nor the session:

    import siril_tpu_torch.pythonmodule as sirilpy
    siril = sirilpy.SirilInterface()
    siril.connect()
    siril.cmd("load", "image.fit")
    data = siril.get_image_pixeldata()
"""

_LAZY = ("SirilError", "SirilInterface", "CommandError")


def __getattr__(name):
    if name in _LAZY:
        from siril_tpu_torch.pythonmodule import connection

        return getattr(connection, name)
    raise AttributeError(name)
