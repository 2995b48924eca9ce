"""Chip-spec registry of the port: peak FLOP/s, HBM and interconnect
bandwidth per NVIDIA card, keyed by substrings of
`torch.cuda.get_device_name()` (the port of `tpu_dp.obs.chips`, with
NVIDIA entries only).

Values are the data-sheet numbers of the NVIDIA H100 Tensor Core GPU
datasheet: ``peak_flops`` is the dense bf16 tensor-core peak per card
(without sparsity: the sparse figures, such as 1,979 TFLOP/s, are not the
denominator), ``hbm_gbs`` the HBM bandwidth per card, ``link_gbs`` the
NVLink bandwidth per card. The bf16 peak is the MFU denominator for f32
runs too: the JAX package's definition, so one MFU means the same in both
packages. A name no entry matches returns None, and every consumer then
publishes no utilization rather than a wrong one.

Import-light on purpose (no torch): consulted by post-hoc tooling in
processes with no card attached.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    """One card's data-sheet peaks (None = unknown, never 0)."""

    name: str                 # canonical short name, e.g. "h100-sxm"
    peak_flops: float         # dense bf16 tensor-core FLOP/s per card
    hbm_gbs: float | None     # HBM bandwidth, GB/s per card
    link_gbs: float | None    # NVLink bandwidth, GB/s per card


#: NVIDIA H100 Tensor Core GPU datasheet: SXM5 989.4 TFLOP/s dense bf16,
#: 3.35 TB/s HBM3, 900 GB/s NVLink; PCIe 756 TFLOP/s, 2.0 TB/s HBM2e,
#: 600 GB/s NVLink bridge; NVL 835 TFLOP/s, 3.9 TB/s HBM3, 600 GB/s.
_H100_SXM = ChipSpec("h100-sxm", 989.4e12, 3350.0, 900.0)
_H100_PCIE = ChipSpec("h100-pcie", 756e12, 2000.0, 600.0)
_H100_NVL = ChipSpec("h100-nvl", 835e12, 3900.0, 600.0)

#: (device-name substring, spec), lower case; first match wins, so the
#: PCIe and NVL parts are tested before the SXM part's "h100 80gb hbm3".
CHIP_SPECS: tuple[tuple[str, ChipSpec], ...] = (
    ("h100 pcie", _H100_PCIE),
    ("h100 nvl", _H100_NVL),
    ("h100 80gb hbm3", _H100_SXM),
    ("h100 sxm", _H100_SXM),
)


def chip_spec(device_name: str) -> ChipSpec | None:
    """The spec for a ``torch.cuda.get_device_name()`` string, or None."""
    name = str(device_name).lower()
    for sub, spec in CHIP_SPECS:
        if sub in name:
            return spec
    return None


def peak_flops(device_name: str) -> float | None:
    """Dense bf16 FLOP/s per card (the MFU denominator), or None."""
    spec = chip_spec(device_name)
    return None if spec is None else spec.peak_flops


def hbm_gbs(device_name: str) -> float | None:
    """HBM bandwidth GB/s per card, or None when unknown."""
    spec = chip_spec(device_name)
    return None if spec is None else spec.hbm_gbs


def link_gbs(device_name: str) -> float | None:
    """NVLink bandwidth GB/s per card, or None when unknown."""
    spec = chip_spec(device_name)
    return None if spec is None else spec.link_gbs
