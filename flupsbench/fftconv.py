"""The plain references' arithmetic: a 3-D convolution by separable FFTs in
plain PyTorch (``torch.fft``), written for this benchmark and sharing no
code with the program.

``store``: None keeps every intermediate in the working precision (the
reference).  A dtype (``torch.bfloat16``) rounds the input, the Green's
function and each stage's result to it, as a program that kept its arrays
in that precision would: the control, which has to come out not correct.
"""
from __future__ import annotations

import torch


def keep(t: torch.Tensor, store) -> torch.Tensor:
    """``t`` rounded to ``store`` and back (a no-op when ``store`` is None);
    a complex tensor is rounded part by part."""
    if store is None:
        return t
    if t.is_complex():
        re, im = t.real, t.imag
        return torch.complex(re.to(store).to(re.dtype),
                             im.to(store).to(im.dtype))
    return t.to(store).to(t.dtype)


def convolve(f: torch.Tensor, ghat: torch.Tensor, m, store=None):
    """``crop(irfftn(rfftn(pad(f, m)) * ghat))`` over the last three axes
    of the real ``f``: ``m`` is the transform length per axis (the doubled
    domain of an unbounded direction, the grid of a periodic one) and the
    result has ``f``'s extent.  ``ghat`` has shape
    ``(m[0], m[1], m[2] // 2 + 1)``, real."""
    n = f.shape[-3:]
    x = keep(torch.fft.rfft(keep(f, store), n=m[2], dim=-1), store)
    x = keep(torch.fft.fft(x, n=m[1], dim=-2), store)
    x = keep(torch.fft.fft(x, n=m[0], dim=-3), store)
    x = keep(x * keep(ghat, store), store)
    # the crop commutes with the transforms along the other axes
    x = keep(torch.fft.ifft(x, dim=-3)[..., :n[0], :, :], store)
    x = keep(torch.fft.ifft(x, dim=-2)[..., :, :n[1], :], store)
    return keep(torch.fft.irfft(x, n=m[2], dim=-1)[..., :n[2]], store)


def grid_points(config: dict) -> int:
    """Points per direction of the user's array: ``n + 1`` nodes or ``n``
    cells."""
    return config["n"] + (1 if config["layout"] == "node" else 0)
