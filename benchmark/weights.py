"""Seeded weights and queue, made on the device in one draw.

`make(spec, seed, device)` draws one standard normal vector for every
random tensor of `spec` (`reference/nets.py`'s `spec_*`) from a
`torch.Generator` on `device` seeded with `seed`, and cuts it: a
convolution's kernel scaled by sqrt(2 / fan_in), a linear layer's by
sqrt(1 / fan_in), the ViT's class token by 0.02; BatchNorm and LayerNorm
scales are 1, but the last BatchNorm of each residual branch, whose scale
is `residual_gamma`; biases and running means 0, running variances 1.
The same dict is loaded into the program's encoder and read by the
reference.
"""

from __future__ import annotations

import math

import torch

KINDS_RANDOM = ("conv", "linear", "token")


def make(spec: list, seed: int, device, dtype=torch.float32,
         residual_gamma: float = 1.0) -> tuple[dict, torch.Generator]:
    """({name: tensor}, the generator, left after the draw for the queue)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, kind in spec if kind in KINDS_RANDOM]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind in KINDS_RANDOM:
            n = math.prod(shape)
            fan_in = math.prod(shape[1:])
            std = {"conv": math.sqrt(2.0 / fan_in), "linear": math.sqrt(1.0 / fan_in),
                   "token": 0.02}[kind]
            out[name] = (flat[at:at + n] * std).reshape(shape).to(dtype)
            at += n
        else:
            fill = {"one": 1.0, "zero": 0.0, "residual": residual_gamma}[kind]
            out[name] = torch.full(shape, fill, device=device, dtype=dtype)
    return out, gen


def queue(gen: torch.Generator, rows: int, dim: int) -> torch.Tensor:
    """(rows, dim) random unit rows from the generator's next draw."""
    q = torch.randn((rows, dim), generator=gen, device=gen.device)
    return q / q.norm(dim=1, keepdim=True).clamp_min(1e-12)


def kinds(spec: list) -> dict:
    return {name: kind for name, _, kind in spec}
