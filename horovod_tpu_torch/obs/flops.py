"""Analytic FLOP model and the card's peak, for throughput and MFU.

The port of the JAX package's ``obs/flops.py``: the transformer's
6N + attention rule of thumb is the same; the peak table is the card's.
The TPU peaks of the JAX package do not carry over.
"""

from __future__ import annotations

from typing import Optional

# Dense bf16 tensor-core peak per card, TFLOP/s, from NVIDIA's data sheet
# (H100 SXM at its full 700 W power limit), keyed by a lower-case
# substring of torch.cuda.get_device_name(). "NVIDIA H100 80GB HBM3" is
# the SXM part; other H100 variants have other peaks and are not listed.
PEAK_TFLOPS_BF16 = {
    "h100 80gb hbm3": 989.0,
}


def peak_tflops(device_name: str) -> float:
    """Dense bf16 peak of the named card; NaN when it is not in the table
    (the CPU, other cards), so an MFU computed from it is not claimed."""
    name = (device_name or "").lower()
    for key, peak in PEAK_TFLOPS_BF16.items():
        if key in name:
            return peak
    return float("nan")


def transformer_flops_per_token(
    n_params: int, n_layers: int, seq_len: int, d_model: int
) -> float:
    """Training FLOPs per token: 6 x the matmul-participating parameters
    (pass ``n_params`` without the embedding tables, as the JAX package's
    bench does) plus the 12 * L * s * d attention term."""
    return 6.0 * n_params + 12.0 * n_layers * seq_len * d_model


def mfu(
    tokens_per_sec: float, flops_per_token: float, device_name: str = "",
    peak: Optional[float] = None,
) -> Optional[float]:
    """Model FLOPs utilization, or None when the card's peak is unknown."""
    if peak is None:
        peak = peak_tflops(device_name)
    if not peak or peak != peak:  # 0 or NaN
        return None
    return tokens_per_sec * flops_per_token / 1e12 / peak
