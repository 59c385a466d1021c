"""Seeded synthetic 10-bit 4:2:0 content, made on the device.

A torch rewrite of tools/gen_test_content.gen_frame (a plasma of three
sinusoids under a camera pan, moving boxes, noise) in which the seed
picks more than the noise: the plasma's phases and where each box is on
its path.  What sets the work (pan, plasma periods and drifts, box sizes,
paths and speeds, noise level) is fixed by the traffic file, so seeds
differ in content but not in its statistics.

The clip is periodic: every motion completes a whole number of cycles in
`frames` frames and each frame's noise is drawn once, so a replayed clip
runs on without a cut: the plasma periods divide the pan's travel over
the clip.
"""
from __future__ import annotations

import math

import torch


def _uniform(g, n, device):
    return torch.rand(n, generator=g, device=device, dtype=torch.float64)


def make_clip(spec: dict, w: int, h: int, seed: int, device,
              count=None) -> tuple:
    """(y, u, v) host int16 arrays of shape (count, h, w) and (count,
    h/2, w/2), samples in [0, 1023]; count defaults to the clip's period,
    spec["frames"].  spec: the traffic file's "content" section.  The same
    seed on the same kind of device gives the same clip.

    The seed picks the plasma's phases, where on its circular path each
    box starts, and the noise.  Everything that sets how much work a frame
    is stays fixed: the pan's direction and speed, the drifts, and each
    box's size, slot in a 3 x 2 grid, radius and turn."""
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    n = int(spec["frames"])
    count = n if count is None else int(count)
    chunk = int(spec.get("chunk", 8))
    vx, vy = (float(a) for a in spec["pan"])
    per = spec["periods"]               # luma x, luma y, diagonal, u, v
    drift = [float(d) for d in spec["drift_cycles"]]
    phases = _uniform(g, 5, device).tolist()
    boxes = spec["boxes"]
    th = (_uniform(g, len(boxes), device) * 2 * math.pi).tolist()
    ny, nl = float(spec["noise_luma"]), float(spec["noise_chroma"])

    f32 = torch.float32
    xx = torch.arange(w, device=device, dtype=f32)[None, None, :]
    yy = torch.arange(h, device=device, dtype=f32)[None, :, None]
    xc = torch.arange(0, w, 2, device=device, dtype=f32)[None, None, :]
    yc = torch.arange(0, h, 2, device=device, dtype=f32)[None, :, None]
    two_pi = 2 * math.pi
    ys, us, vs = [], [], []
    for t0 in range(0, count, chunk):
        t = torch.arange(t0, min(count, t0 + chunk), device=device,
                         dtype=f32)[:, None, None]
        m = t.shape[0]
        ph = t / n
        xs, ysh = xx - vx * t, yy - vy * t
        y = (96.0
             + 60.0 * torch.sin(two_pi * (xs / per[0] + phases[0]
                                          + drift[0] * ph))
             + 40.0 * torch.cos(two_pi * (ysh / per[1] + phases[1]
                                          + drift[1] * ph))
             + 20.0 * torch.sin(two_pi * ((xs + ysh) / per[2] + phases[2]
                                          + drift[2] * ph)))
        for k, (bw, bh, r, lvl) in enumerate(boxes):
            sx, sy = k % 3, k // 3
            a = two_pi * (1 - 2 * (k % 2)) * ph + th[k]
            bx = torch.floor(w * (2 * sx + 1) / 6 + r * torch.cos(a) - bw / 2)
            by = torch.floor(h * (2 * sy + 1) / 4 + r * torch.sin(a) - bh / 2)
            inside = ((xx >= bx) & (xx < bx + bw) & (yy >= by)
                      & (yy < by + bh))
            y = torch.where(inside, torch.full_like(y, float(lvl)), y)
        y = y * 4.0 + ny * torch.randn((m, h, w), generator=g, device=device)
        xcs, ycs = xc - vx * t, yc - vy * t
        u = 512.0 + 120.0 * torch.sin(two_pi * (xcs / per[3] + phases[3]))
        v = 512.0 + 120.0 * torch.cos(two_pi * (ycs / per[4] + phases[4]))
        u = u + nl * torch.randn((m, h // 2, w // 2), generator=g,
                                 device=device)
        v = v + nl * torch.randn((m, h // 2, w // 2), generator=g,
                                 device=device)
        for lst, p in ((ys, y), (us, u), (vs, v)):
            lst.append(torch.clamp(torch.round(p), 0, 1023).to(torch.int16))
    return tuple(torch.cat(lst).cpu().numpy() for lst in (ys, us, vs))


def frames(clip):
    """The endless feed: the clip's frames in order, replayed."""
    y, u, v = clip
    n = len(y)
    i = 0
    while True:
        yield y[i % n], u[i % n], v[i % n]
        i += 1


def source_frame(clip, disp: int):
    """The source (y, u, v) of display index `disp` of the feed."""
    y, u, v = clip
    n = len(y)
    return y[disp % n], u[disp % n], v[disp % n]
