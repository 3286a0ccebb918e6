"""The yardstick's table of peaks and the roofline bound of one kernel call.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W, dense (no
sparsity): 989 TFLOP/s bf16 on the tensor cores, 494.5 TFLOP/s tf32 (fp32
products as three tf32 passes: a third of that), 67 TFLOP/s fp32 outside the
tensor cores, 3.35 TB/s of HBM3. A card set below 700 W runs slower; the run
prints its power limit beside every share of a peak.
"""

from __future__ import annotations

from dataclasses import dataclass

BF16_FLOPS = 989e12
TF32_FLOPS = 494.5e12
TF32X3_FLOPS = TF32_FLOPS / 3
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
BF16 = 2
FP32 = 4


@dataclass(frozen=True)
class Cost:
    """The operations and bytes a kernel call's function needs (each input read
    once, each output written once), and the peak rate of its operations."""
    flops: float
    bytes: float
    peak_flops: float = BF16_FLOPS

    @property
    def bound_s(self) -> float:
        """The least time the card could take: the larger of the two times."""
        return max(self.flops / self.peak_flops, self.bytes / HBM_BYTES_PER_S)
