"""DCT/DST post-twiddle ``y = a * Re(x) + b * Im(x)``: wrapper of the CUDA
kernel in ``csrc/twiddle_pack.cu``.

Counterpart of ``twiddle_pack`` in ``repro.kernels.twiddle_pack``, which
takes separate (re, im) planes; here ``x`` is torch's interleaved complex
tensor, read in place: its rows may lie at any pitch, so a window
``f[:, start:start+k]`` of a contiguous half spectrum needs no copy.

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

__all__ = ["twiddle_pack"]


def twiddle_pack(x, a, b):
    """``a * Re(x) + b * Im(x)`` for a complex ``x`` (rows, k) whose last
    axis is unit-stride, with real (k,) tables ``a``/``b`` of ``x``'s
    precision.  Returns a contiguous real (rows, k) tensor."""
    if x.dtype not in (torch.complex64, torch.complex128):
        raise TypeError(f"twiddle_pack: x must be complex64/128, got "
                        f"{x.dtype}")
    if x.is_conj():
        raise ValueError("twiddle_pack: x is a lazy conjugate view; "
                         "resolve_conj() it first")
    if x.ndim != 2:
        raise ValueError(f"twiddle_pack: x must be (rows, k), got "
                         f"{tuple(x.shape)}")
    rows, k = x.shape
    if k > 1 and x.stride(1) != 1:
        raise ValueError("twiddle_pack: x's last axis must be unit-stride")
    pitch = x.stride(0) if rows > 1 else k
    if pitch < k:
        raise ValueError(f"twiddle_pack: rows overlap (pitch {pitch} < "
                         f"k {k})")
    rdt = ref._rdt(x)
    for name, t in (("a", a), ("b", b)):
        if (t.dtype != rdt or tuple(t.shape) != (k,)
                or not t.is_contiguous()):
            raise ValueError(f"twiddle_pack: {name} must be a contiguous "
                             f"{rdt} tensor of shape ({k},), got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"twiddle_pack: {name} and x on different "
                             "devices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"twiddle_pack: unsupported device {x.device}")
    if x.device.type == "cpu" and not is_fake(x):
        out = ref.twiddle_pack(x, a, b)
    else:
        out = torch.empty((rows, k), dtype=rdt, device=x.device)
    if _trace.active():
        _trace.kernel_call("twiddle_pack", x, out)
    if x.device.type == "cpu" or is_fake(x):
        return out
    if out.numel():
        lib = library()
        fn = (lib.repro_twiddle_pack_f64 if rdt == torch.float64
              else lib.repro_twiddle_pack_f32)
        err = fn(x.data_ptr(), pitch, a.data_ptr(), b.data_ptr(),
                 out.data_ptr(), rows, k,
                 torch.cuda.current_stream(x.device).cuda_stream)
        check(err, "twiddle_pack kernel launch")
        LAUNCHES["twiddle_pack"] += 1
    return out
