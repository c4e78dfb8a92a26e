"""Published peak rates of the cards the benchmark runs on.

Frozen copy of ``CARDS`` / ``card_rates`` from
``src/repro_torch/launch/trace_analysis.py`` at commit 3b55662 (NVIDIA's
H100 data sheets, dense rates at the full power limit).  Kept here so that
a change to the program cannot move the peaks a share is taken against.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Card:
    hbm_bytes_s: float      # device memory bytes/s
    bf16_flops: float       # bf16 / fp16 tensor-core FLOP/s
    fp32_flops: float       # fp32 FLOP/s outside the tensor cores
    fp64_flops: float       # fp64 FLOP/s outside the tensor cores
    nvlink_bytes_s: float   # NVLink bytes/s each way
    memory_bytes: float     # device memory


#: By a substring of the name ``torch.cuda.get_device_name()`` reports.
CARDS = {
    "H100 80GB HBM3": Card(3.35e12, 989e12, 67e12, 34e12, 450e9, 80e9),
    "H100 PCIe": Card(2.0e12, 756e12, 51e12, 26e12, 300e9, 80e9),
    "H100 NVL": Card(3.9e12, 835e12, 60e12, 30e12, 300e9, 94e9),
}


def card_rates(name: str) -> Card:
    """The rates of the card whose reported name contains a ``CARDS`` key;
    raises ``KeyError`` for a card with no recorded rates."""
    for key, card in CARDS.items():
        if key in name:
            return card
    raise KeyError(f"no peak rates recorded for card {name!r}")
