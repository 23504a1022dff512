"""ctypes wrapper of the SSD chunk-scan kernel (``csrc/ssd_scan.cu``).

For CUDA tensors :func:`ssd_scan_cuda` launches the kernel (or raises);
for CPU tensors it runs the plain version, ``ref.ssd_ref``.  ``launches``
counts kernel launches only."""
from __future__ import annotations

import ctypes

import torch

from .. import build
from ..common import LaunchCounter
from .ref import ssd_ref

launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
#: Largest head dim, state size and chunk length the kernel takes (its
#: largest padded-width instances and its shared-memory cumsum).
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 1024


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_scan_launch.restype = ctypes.c_int
    lib.ssd_scan_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                    _I, _I, _I, _P]
    return lib


def check_inputs(xdt, Bm, Cm, a) -> None:
    if xdt.ndim != 5 or Bm.ndim != 5 or Cm.shape != Bm.shape or a.ndim != 4:
        raise ValueError(f"xdt must be (B, H, nc, Lc, hd), Bm and Cm "
                         f"(B, G, nc, Lc, N), a (B, H, nc, Lc); got "
                         f"{tuple(xdt.shape)}, {tuple(Bm.shape)}, "
                         f"{tuple(Cm.shape)}, {tuple(a.shape)}")
    B, H, nc, Lc = xdt.shape[:4]
    G = Bm.shape[1]
    if (Bm.shape[0], *Bm.shape[2:4]) != (B, nc, Lc) or \
            a.shape != xdt.shape[:4] or G < 1 or H % G:
        raise ValueError(f"xdt {tuple(xdt.shape)}, Bm {tuple(Bm.shape)} and "
                         f"a {tuple(a.shape)} disagree on (B, H, nc, Lc), "
                         f"or G does not divide H")
    if xdt.dtype not in DTYPES or any(t.dtype != xdt.dtype
                                      for t in (Bm, Cm, a)):
        raise ValueError(f"xdt, Bm, Cm, a must share one of {DTYPES}, got "
                         f"{xdt.dtype}, {Bm.dtype}, {Cm.dtype}, {a.dtype}")
    if not xdt.device == Bm.device == Cm.device == a.device:
        raise ValueError(f"xdt, Bm, Cm, a on {xdt.device}, {Bm.device}, "
                         f"{Cm.device}, {a.device}")


def ssd_scan_cuda(xdt, Bm, Cm, a) -> torch.Tensor:
    """The SSD chunk scan from a zero state: xdt (B, H, nc, Lc, hd), Bm, Cm
    (B, G, nc, Lc, N) with head h reading group h // (H // G), a (B, H, nc,
    Lc) -> y (B, H, nc, Lc, hd) in xdt's dtype.  One thread block per
    (b, h) walks the chunks in order."""
    check_inputs(xdt, Bm, Cm, a)
    if xdt.device.type == "cpu":
        return ssd_ref(xdt, Bm, Cm, a)
    B, H, nc, Lc, hd = xdt.shape
    N = Bm.shape[-1]
    if hd > MAX_HEAD_DIM or N > MAX_STATE or Lc > MAX_CHUNK:
        raise NotImplementedError(
            f"ssd_scan kernel takes hd <= {MAX_HEAD_DIM}, N <= {MAX_STATE} "
            f"and Lc <= {MAX_CHUNK}, got hd={hd}, N={N}, Lc={Lc}")
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel runs on CUDA tensors, got "
                         f"{xdt.device}")
    xdt, Bm, Cm, a = (t.contiguous() for t in (xdt, Bm, Cm, a))
    y = torch.empty_like(xdt)
    if y.numel() == 0:
        return y
    lib = _lib()
    with torch.cuda.device(xdt.device):
        stream = torch.cuda.current_stream(xdt.device).cuda_stream
        err = lib.ssd_scan_launch(
            xdt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            y.data_ptr(), B * H, H, Bm.shape[1], nc, Lc, hd, N,
            int(xdt.dtype == torch.bfloat16), stream)
    build.check(lib, err, "ssd_scan kernel launch")
    launches.count += 1
    return y
