"""A synthetic frame pair with a known answer: band-limited noise and its
copy translated by a sub-pixel shift, and the mean end-point error of a
flow against that shift; and a sequence of such frames for the streaming
path. ``chip_smoke.py``, ``profile_pair`` and the bench drive the solver
with them."""

from __future__ import annotations

import numpy as np

SHIFT = (1.25, -0.75)   # true (u, v) of the textured pair, px
MARGIN = 24             # border px left out of the shift check


def textured_pair(w: int, h: int, shift=SHIFT, seed: int = 0, corr: float = 2.5):
    """Gaussian-filtered noise scaled to 0-255 and its copy translated by
    ``shift`` (band-limited, periodic, so the translation is exact)."""
    f0, f1 = textured_frames(w, h, [(0.0, 0.0), shift], seed, corr)
    return f0, f1


def textured_frames(w: int, h: int, shifts, seed: int = 0, corr: float = 2.5) -> list:
    """The texture of ``textured_pair`` translated by each of ``shifts``
    ((u, v) px), all scaled to 0-255 by the untranslated texture's range: a
    sequence whose consecutive frames move by the differences of the shifts."""
    rng = np.random.default_rng(seed)
    ky = np.fft.fftfreq(h)[:, None]
    kx = np.fft.fftfreq(w)[None, :]
    spec = np.fft.fft2(rng.standard_normal((h, w)))
    spec *= np.exp(-2.0 * (np.pi * corr) ** 2 * (kx ** 2 + ky ** 2))
    t0 = np.real(np.fft.ifft2(spec))
    lo, hi = t0.min(), t0.max()
    return [((np.real(np.fft.ifft2(spec * np.exp(-2j * np.pi * (kx * su + ky * sv)))) - lo)
             / (hi - lo) * 255.0).astype(np.float32) for su, sv in shifts]


def shift_epe(u, v, shift=SHIFT, margin=MARGIN) -> float:
    """Interior mean end-point error of (u, v) against the constant ``shift``."""
    m = (slice(margin, -margin), slice(margin, -margin))
    return float(np.mean(np.hypot(u[m] - shift[0], v[m] - shift[1])))
