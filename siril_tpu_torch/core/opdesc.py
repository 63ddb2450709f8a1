"""Per-operation descriptors — counterpart of ``siril_tpu/core/opdesc.py``
(the same ids, names, ``mem_ratio`` values and flags); the reference's
``src/core/op_descriptor.h``
(op_descriptor struct, ``op_descriptors.def``): one const record per image
op capturing the invariants that would otherwise be duplicated across
every command/GUI construction site — stable id, display name, memory
ratio (device-budget planning), and capability flags (mask-aware,
geometry-changing, RGB/mono requirements).

The command layer consults this registry for ``[-mask]`` support and the
engine uses ``mem_ratio`` when planning block sizes for seq-variants.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# capability flags (op_descriptor.h:32-38)
OP_MASK_CAPABLE = 1 << 0
OP_GEOMETRY_CHANGING = 1 << 1
OP_EXPENSIVE = 1 << 2
OP_REQ_RGB = 1 << 3
OP_REQ_MONO = 1 << 4


@dataclass(frozen=True)
class OpDescriptor:
    id: str                    # stable "area.op" identity
    name: str                  # display / progress text
    mem_ratio: float = 1.0     # device memory per input pixel (×f32)
    flags: int = 0

    @property
    def mask_capable(self) -> bool:
        return bool(self.flags & OP_MASK_CAPABLE)

    @property
    def geometry_changing(self) -> bool:
        return bool(self.flags & OP_GEOMETRY_CHANGING)


_REGISTRY: Dict[str, OpDescriptor] = {}


def register(desc: OpDescriptor) -> OpDescriptor:
    _REGISTRY[desc.id] = desc
    return desc


def get(op_id: str) -> Optional[OpDescriptor]:
    return _REGISTRY.get(op_id)


def all_ops() -> Dict[str, OpDescriptor]:
    return dict(_REGISTRY)


# ---------------------------------------------------------------------------
# descriptor table (op_descriptors.def equivalent)
# ---------------------------------------------------------------------------

M = OP_MASK_CAPABLE
G = OP_GEOMETRY_CHANGING
E = OP_EXPENSIVE

for _d in [
    # filters
    OpDescriptor("filters.gauss", "Gaussian blur", 2.0, M),
    OpDescriptor("filters.unsharp", "Unsharp mask", 3.0, M),
    OpDescriptor("filters.fmedian", "Median filter", 2.0, M),
    OpDescriptor("filters.clahe", "CLAHE", 3.0, M),
    OpDescriptor("filters.epf", "Edge-preserving filter", 4.0, M),
    OpDescriptor("filters.banding", "Banding reduction", 2.0, M),
    OpDescriptor("filters.rmgreen", "SCNR", 2.0, M | OP_REQ_RGB),
    OpDescriptor("filters.satu", "Saturation", 2.0, M | OP_REQ_RGB),
    OpDescriptor("filters.unpurple", "Unpurple", 3.0, M | OP_REQ_RGB),
    OpDescriptor("filters.rgradient", "Rotational gradient", 3.0, M),
    OpDescriptor("filters.denoise", "NL-Bayes denoise", 8.0, M | E),
    OpDescriptor("filters.atrous", "Wavelet denoise", 6.0, M | E),
    OpDescriptor("filters.rl", "Richardson-Lucy", 6.0, M | E),
    OpDescriptor("filters.sb", "Split-Bregman TV", 8.0, M | E),
    OpDescriptor("filters.wiener", "Wiener", 4.0, M | E),
    OpDescriptor("filters.fft", "FFT decomposition", 6.0, 0),
    OpDescriptor("filters.linear_match", "Linear match", 2.0, 0),
    OpDescriptor("filters.synthstar", "Star resynthesis", 4.0, M | E),
    # stretches
    OpDescriptor("stretch.mtf", "Midtones transfer", 1.0, M),
    OpDescriptor("stretch.ght", "Generalized hyperbolic", 1.0, M),
    OpDescriptor("stretch.asinh", "Asinh stretch", 1.0, M),
    OpDescriptor("stretch.linstretch", "Linear stretch", 1.0, M),
    OpDescriptor("stretch.autostretch", "Auto-stretch", 1.5, M),
    OpDescriptor("stretch.curves", "Curves", 1.0, M),
    # color
    OpDescriptor("color.ccm", "Color matrix", 1.0, M | OP_REQ_RGB),
    OpDescriptor("color.neg", "Negative", 1.0, M),
    OpDescriptor("color.split", "Channel split", 1.5, OP_REQ_RGB),
    OpDescriptor("color.rgbcomp", "RGB composition", 2.0, G),
    OpDescriptor("color.pcc", "Photometric color calibration",
                 3.0, OP_REQ_RGB | E),
    OpDescriptor("color.spcc", "Spectrophotometric CC",
                 3.0, OP_REQ_RGB | E),
    # geometry
    OpDescriptor("geom.crop", "Crop", 1.0, G),
    OpDescriptor("geom.rotate", "Rotate", 3.0, G | E),
    OpDescriptor("geom.resample", "Resample", 3.0, G | E),
    OpDescriptor("geom.mirror", "Mirror", 1.0, G),
    OpDescriptor("geom.binning", "Binning", 1.0, G),
    # background / calibration
    OpDescriptor("bkg.subsky", "Background extraction", 4.0, M | E),
    OpDescriptor("calib.calibrate", "Calibration", 4.0, E),
    OpDescriptor("calib.cosme", "Cosmetic correction", 2.0, 0),
    # arithmetic / pixel math
    OpDescriptor("arith.imoper", "Image arithmetic", 2.0, M),
    OpDescriptor("arith.pm", "Pixel math", 3.0, M | E),
    # stacking / registration (sequence-level, EXPENSIVE)
    OpDescriptor("stack.rej", "Rejection stacking", 16.0, E),
    OpDescriptor("stack.drizzle", "Drizzle", 12.0, G | E),
    OpDescriptor("reg.global", "Global star registration", 8.0, G | E),
    OpDescriptor("reg.apply", "Apply registration", 6.0, G | E),
    OpDescriptor("reg.mpp", "Multipoint planetary", 16.0, E),
]:
    register(_d)
