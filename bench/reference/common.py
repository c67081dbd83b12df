"""What the plain references share: the seeded draws of the benchmark's
parameters, the RMS norm, and matrix products at the reference's float32
or at the fp8 control's precision."""

from __future__ import annotations

import torch

#: the largest finite float8 e4m3 value
FP8_MAX = 448.0


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % 2 ** 63)
    return g


def normal(g, shape, std, device, dtype):
    return torch.randn(shape, generator=g, device=device,
                       dtype=dtype).mul_(std)


def around_one(g, shape, device, dtype):
    return normal(g, shape, 0.1, device, dtype).add_(1.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 under one scale, its absolute maximum
    over the whole tensor (per-tensor scaling), back in float32."""
    scale = x.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Mat:
    """Matrix products at one precision: float32, or the fp8 control
    (weight and input each rounded to float8 e4m3 with a per-tensor
    scale, the product accumulated in float32)."""

    def __init__(self, precision: str):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.fp8 = precision == "fp8"

    def w(self, t: torch.Tensor) -> torch.Tensor:
        t = t.float()
        return fp8(t) if self.fp8 else t

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x = fp8(x)
        return x @ w


def rms(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()
