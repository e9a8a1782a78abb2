"""The cards' published peaks, and what a per-layer reader is handed.

Peaks are NVIDIA's data-sheet figures for the SXM H100 (dense, no
sparsity), at the card's full power limit of 700 W; the run's ``device``
line carries the power limit it ran at.
"""

from __future__ import annotations

from dataclasses import dataclass

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes": 3.35e12},
}


def card_peaks():
    """The current card's peaks, or None for a card not in the table."""
    import torch

    return PEAKS.get(torch.cuda.get_device_name(0))


def percentile(values, q):
    """The ``q``-th percentile, linear between order statistics."""
    v = sorted(values)
    x = (len(v) - 1) * q / 100
    lo = int(x)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (x - lo)


@dataclass
class Context:
    """What a metric's reader is handed: the traffic's ``kind``, the
    configuration's shapes (its layout's ``Arch``, ``manifest.arch``), the
    traffic's parameters,
    the number of cards and the run's ``cells.Outcome``, whose ``span``
    (``tracing.Span``) is the traced span of a ``--trace 1`` run."""

    kind: str
    arch: object
    traffic: dict
    chips: int
    outcome: object

    @property
    def span(self):
        return self.outcome.span

    @property
    def peaks(self):
        return card_peaks()

    def kernel_seconds(self, part):
        """Device seconds and records of the kernels whose name holds
        ``part``."""
        hits = [v for k, v in self.span.kernels.items() if part in k]
        return sum(s for _, s in hits), sum(n for n, _ in hits)
