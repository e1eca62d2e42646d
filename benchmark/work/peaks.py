"""Published peak rates of the cards the benchmark may run on.

NVIDIA's H100 data sheet, SXM part, dense rates at the full 700 W power
limit: 3.35 TB/s of HBM3 bandwidth, 67 TFLOP/s in float32 outside the
tensor cores (the sparse products run on the CUDA cores). A card set to
a lower power limit runs slower under load; the benchmark prints the
card's limit beside every share of these peaks.
"""

from __future__ import annotations

# (substring of torch.cuda.get_device_name(), peaks)
PEAKS = (
    ("H100 80GB HBM3", {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12,
              "source": "NVIDIA H100 data sheet, SXM, dense"}),
)


def peaks_for(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name``, or None for a card
    the table does not hold (a share of its roofline is then not
    reported)."""
    for key, peaks in PEAKS:
        if key in device_name:
            return peaks
    return None
