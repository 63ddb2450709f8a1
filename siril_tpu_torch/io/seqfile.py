""".seq sidecar text format, v7-compatible — counterpart of
``siril_tpu/io/seqfile.py`` (``read_seqfile``:34, ``_attach_backing_store``
:119, ``write_seqfile``:152; reference ``src/io/seqfile.c`` readseqfile:85,
writeseqfile:720).  Cards:

  S 'name' beg number selnum fixed ref version [variable fz drizzle]
  TS / TA / TF            sequence type (SER / film / FITS cube)
  L nb_layers
  I filenum incl [rx,ry]  (the size of each frame of a variable-size sequence)
  Rx fwhm wfwhm roundness quality bg nbstars H h00..h22
  Mx-y total ngoodpix mean median sigma avgdev mad sqrtbwmv loc scale min max norm bgnoise
  D/O/E cards — kept as opaque lines and written back unchanged.

Sequences of FITS files (of one size, or of each frame's own size;
``.fit.fz`` files when the fz flag is set), of a ``.ser`` video (``TS``),
of a FITS cube (``TF``) and of a film (``TA``: ``name`` + a film
extension beside the ``.seq``; the JAX package reads ``TA`` as a
sequence of files).
"""

from __future__ import annotations

import os
import shlex
from typing import Optional

import numpy as np

from siril_tpu_torch.core.sequence import (
    SEQ_AVI,
    SEQ_FITSEQ,
    SEQ_SER,
    STAT_COLS,
    Sequence,
)

CURRENT_SEQFILE_VERSION = 7

_TYPE_CARDS = {"S": SEQ_SER, "F": SEQ_FITSEQ, "A": SEQ_AVI}


def read_seqfile(path: str) -> Sequence:
    if not path.endswith(".seq"):
        path = path + ".seq"
    directory = os.path.dirname(os.path.abspath(path))
    seq: Optional[Sequence] = None
    img_i = 0
    reg_i = {}
    opaque = []
    with open(path, "r") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            c0 = line[0]
            if c0 == "S":
                toks = shlex.split(line[1:])
                seq = Sequence(toks[0], directory)
                seq.beg = int(toks[1])
                seq.number = int(toks[2])
                # toks[3] = selnum (recomputed), toks[4] = fixed
                seq.fixed_len = int(toks[4])
                seq.reference_image = int(toks[5])
                if len(toks) > 7:
                    seq.is_variable = bool(int(toks[7]))
                if len(toks) > 8:
                    seq.fz = bool(int(toks[8]))
                seq.filenum = np.zeros(seq.number, dtype=np.int64)
                seq.incl = np.ones(seq.number, dtype=bool)
                if seq.is_variable:
                    seq.imgsize = np.zeros((seq.number, 2), dtype=np.int64)
            elif c0 == "T" and seq is not None:
                t = line[1] if len(line) > 1 else "F"
                if t not in _TYPE_CARDS:
                    raise ValueError(f"{path}: unknown sequence type T{t}")
                seq.seq_type = _TYPE_CARDS[t]
            elif c0 == "L" and seq is not None:
                seq.nb_layers = int(line[1:].split()[0])
            elif c0 == "I" and seq is not None:
                toks = line[1:].split()
                if img_i < seq.number:
                    seq.filenum[img_i] = int(toks[0])
                    seq.incl[img_i] = bool(int(toks[1]))
                    if len(toks) > 2 and "," in toks[2] and \
                            seq.imgsize is not None:
                        rx, ry = toks[2].split(",")
                        seq.imgsize[img_i] = (int(rx), int(ry))
                    img_i += 1
            elif c0 == "R" and seq is not None:
                layer = 0 if line[1] == "*" else int(line[1])
                toks = line[2:].split()
                reg = seq.reg(layer)
                i = reg_i.get(layer, 0)
                if i < seq.number:
                    reg.fwhm[i] = float(toks[0])
                    reg.weighted_fwhm[i] = float(toks[1])
                    reg.roundness[i] = float(toks[2])
                    reg.quality[i] = float(toks[3])
                    reg.background_lvl[i] = float(toks[4])
                    reg.number_of_stars[i] = int(float(toks[5]))
                    if len(toks) > 6 and toks[6] == "H":
                        reg.H[i] = np.array(
                            [float(t) for t in toks[7:16]]).reshape(3, 3)
                    reg.valid[i] = True
                    reg_i[layer] = i + 1
            elif c0 == "M" and seq is not None:
                head, rest = line[1:].split(None, 1)
                layer_c, idx_s = head.split("-")
                layer = 0 if layer_c == "*" else int(layer_c)
                idx = int(idx_s)
                vals = [float(t) for t in rest.split()]
                if idx < seq.number and len(vals) >= len(STAT_COLS):
                    seq.layer_stats(layer)[idx] = vals[:len(STAT_COLS)]
            elif c0 in ("D", "O", "E"):
                opaque.append(line)
    if seq is None:
        raise ValueError(f"{path}: no S card")
    seq._opaque_cards = opaque
    _attach_backing_store(seq)
    return seq


def _attach_backing_store(seq: Sequence) -> None:
    """Open the ``name.ser`` video or find the ``name.fit[s|ts]`` cube
    beside the .seq, or resolve each frame's file
    ``name%0*d.fit[s|ts][.fz]``."""
    if seq.seq_type == SEQ_SER:
        from siril_tpu_torch.io.ser import SerFile

        seq._ser = SerFile(os.path.join(seq.directory, seq.name + ".ser"))
        if seq.nb_layers < 0:
            seq.nb_layers = seq._ser.nchans
        seq.rx, seq.ry = seq._ser.width, seq._ser.height
        return
    if seq.seq_type == SEQ_AVI:
        from siril_tpu_torch.io.films import FILM_EXTENSIONS, open_film

        for ext in FILM_EXTENSIONS:
            p = os.path.join(seq.directory, seq.name + ext)
            if os.path.exists(p):
                seq._film = open_film(p)
                seq.nb_layers, seq.rx, seq.ry = (seq._film.nchans,
                                                 seq._film.w, seq._film.h)
                return
        raise FileNotFoundError(
            f"no film {seq.name}{{{','.join(FILM_EXTENSIONS)}}} in "
            f"{seq.directory}")
    if seq.seq_type == SEQ_FITSEQ:
        for ext in (".fit", ".fits", ".fts"):
            p = os.path.join(seq.directory, seq.name + ext)
            if os.path.exists(p):
                seq._fitseq_path = p
                from siril_tpu_torch.io.fits_io import image_hdus

                seq.nb_layers, seq.ry, seq.rx = image_hdus(p)[0].shape_chw
                break
        return
    exts = ("fit.fz", "fits.fz") if seq.fz else ("fit", "fits", "fts")
    files = []
    for i in range(seq.number):
        num = int(seq.filenum[i])
        found = None
        for ext in exts:
            p = os.path.join(seq.directory,
                             f"{seq.name}{num:0{seq.fixed_len}d}.{ext}")
            if os.path.exists(p):
                found = p
                break
        files.append(found)
    seq._file_list = files
    if (seq.nb_layers < 0 or seq.rx == 0) and any(files):
        seq._probe_geometry()


def write_seqfile(seq: Sequence, path: Optional[str] = None) -> None:
    p = path or seq.seqfile_path()
    lines = [
        "#Siril sequence file. Contains list of images, selection, "
        "registration data and statistics",
        "#S 'sequence_name' start_index nb_images nb_selected fixed_len "
        "reference_image version variable_size fz_flag drizzle",
        "S '%s' %d %d %d %d %d %d %d %d %d" % (
            seq.name, seq.beg, seq.number, seq.selnum, seq.fixed_len,
            seq.reference_image, CURRENT_SEQFILE_VERSION,
            int(seq.is_variable), int(seq.fz), 0)]
    if seq.seq_type == SEQ_SER:
        lines.append("TS")
    elif seq.seq_type == SEQ_FITSEQ:
        lines.append("TF")
    elif seq.seq_type == SEQ_AVI:
        lines.append("TA")
    if seq.nb_layers > 0:
        lines.append(f"L {seq.nb_layers}")
    for i in range(seq.number):
        if seq.is_variable and seq.imgsize is not None:
            lines.append("I %d %d %d,%d" % (
                seq.filenum[i], int(seq.incl[i]), *seq.imgsize[i]))
        else:
            lines.append("I %d %d" % (seq.filenum[i], int(seq.incl[i])))
    lines.extend(seq._opaque_cards)
    for layer, reg in sorted(seq.regparam.items()):
        if not reg.valid.any():
            continue
        for i in range(seq.number):
            H = reg.H[i]
            lines.append(
                "R%d %g %g %g %g %g %d H %g %g %g %g %g %g %g %g %g" % (
                    layer, reg.fwhm[i], reg.weighted_fwhm[i],
                    reg.roundness[i], reg.quality[i], reg.background_lvl[i],
                    int(reg.number_of_stars[i]), *H.ravel()))
    for layer, st in sorted(seq.stats.items()):
        for i in range(seq.number):
            row = st[i]
            if np.isnan(row[2:]).all():
                continue
            lines.append(
                "M%d-%d %ld %ld %g %g %g %g %g %g %g %g %g %g %g %g" % (
                    layer, i, int(row[0]), int(row[1]), *row[2:]))
    with open(p, "w") as f:
        f.write("\n".join(lines) + "\n")
