"""Synthetic DRIVE-geometry data made on the device from a seed, after
``chip_smoke.py``'s ``synthetic_drive``: images in [0, 1] inside a
circular field of view (radius 0.47 of the shorter side), vessel labels
drawn as 12 random walks of 4000 steps an image, 2x2 pixels a step, that
darken the green channel by 0.25.  Every call draws the same sizes, so a
seed changes the content and never the amount of work."""

from __future__ import annotations

import torch

BRANCHES, STEPS = 12, 4000


@torch.no_grad()
def synthetic_drive(n: int, h: int, w: int, generator: torch.Generator,
                    device):
    """(images (n, h, w, 3), masks (n, h, w), labels (n, h, w)), float32
    on ``device``."""
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    fov = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2)
           <= (0.47 * min(h, w)) ** 2).float()
    steps = torch.randint(-2, 3, (n, BRANCHES, STEPS, 2),
                          generator=generator, device=device)
    start = torch.stack([
        torch.randint(0, h, (n, BRANCHES), generator=generator,
                      device=device),
        torch.randint(0, w, (n, BRANCHES), generator=generator,
                      device=device)], dim=-1)
    pts = steps.cumsum(dim=2) + start[:, :, None, :]
    ys = pts[..., 0].clamp(0, h - 2)
    xs = pts[..., 1].clamp(0, w - 2)
    img = torch.arange(n, device=device)[:, None, None].expand_as(ys)
    labels = torch.zeros((n, h, w), device=device)
    for dy in (0, 1):
        for dx in (0, 1):
            labels[img, ys + dy, xs + dx] = 1.0
    labels *= fov
    base = 0.35 + 0.25 * torch.rand((n, h, w, 3), generator=generator,
                                    device=device)
    base[..., 1] -= 0.25 * labels
    images = (base * fov[..., None]).clamp(0.0, 1.0)
    masks = fov.expand(n, h, w).contiguous()
    return images, masks, labels
