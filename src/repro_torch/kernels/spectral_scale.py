"""Fused Green-function multiply + normalization: wrapper of the CUDA
kernel in ``csrc/spectral_scale.cu``.

Counterpart of ``spectral_scale`` in ``repro.kernels.spectral_scale``,
which takes separate (re, im) planes; here the field is one real or
interleaved complex tensor.  The batched form (B, rows, lanes) shares one
(rows, lanes) Green plane across B without broadcasting it into memory.

On a CUDA tensor the wrapper launches the kernel on the current stream and
counts the launch; on a CPU tensor it runs the plain version in ``ref``;
on a fake tensor (the dry run) it returns an output of the right shape
and launches nothing.  Every call is recorded in the open ``core.trace``
traces.
"""
from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import is_fake

from repro_torch.core import trace as _trace

from . import ref
from ._build import LAUNCHES, check, library

__all__ = ["spectral_scale"]

_DTYPES = (torch.float32, torch.float64, torch.complex64, torch.complex128)


def spectral_scale(x, green, scale: float = 1.0):
    """``x * green * scale`` for ``x`` real or complex of shape
    (rows, lanes) or (B, rows, lanes) and ``green`` real (rows, lanes) of
    ``x``'s precision.  Returns a new tensor of ``x``'s shape and dtype."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"spectral_scale: unsupported dtype {x.dtype}")
    rdt = x.real.dtype if x.is_complex() else x.dtype
    if x.ndim not in (2, 3) or not x.is_contiguous():
        raise ValueError(f"spectral_scale: x must be a contiguous (rows, "
                         f"lanes) or (B, rows, lanes) tensor, got "
                         f"{tuple(x.shape)}")
    if (green.dtype != rdt or tuple(green.shape) != tuple(x.shape[-2:])
            or not green.is_contiguous()):
        raise ValueError(f"spectral_scale: green must be a contiguous "
                         f"{rdt} tensor of shape {tuple(x.shape[-2:])}, "
                         f"got {tuple(green.shape)} {green.dtype}")
    if green.device != x.device:
        raise ValueError("spectral_scale: green and x on different devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"spectral_scale: unsupported device {x.device}")
    if x.device.type == "cpu" and not is_fake(x):
        out = ref.spectral_scale(x, green, scale)
    else:
        out = torch.empty_like(x)
    if _trace.active():
        _trace.kernel_call("spectral_scale", x, out)
    if x.device.type == "cpu" or is_fake(x):
        return out
    batch = x.shape[0] if x.ndim == 3 else 1
    plane = green.numel()
    if out.numel():
        lib = library()
        fn = (lib.repro_spectral_scale_f64 if rdt == torch.float64
              else lib.repro_spectral_scale_f32)
        err = fn(x.data_ptr(), int(x.is_complex()), green.data_ptr(),
                 out.data_ptr(), batch, plane, float(scale),
                 torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "spectral_scale kernel launch")
        LAUNCHES["spectral_scale"] += 1
    return out
