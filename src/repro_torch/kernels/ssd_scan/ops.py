"""Public entry point of the SSD chunk scan: the three stage kernels for
CUDA tensors, their plain version (``ref.ssd_ref``) for CPU tensors."""
from __future__ import annotations

from .ssd_scan import ssd_scan_cuda


def ssd(xdt, Bm, Cm, a):
    """xdt (B, H, nc, Lc, hd); Bm, Cm (B, G, nc, Lc, N), head h reading
    group h // (H // G); a (B, H, nc, Lc).  Any strides; y comes back as a
    (B, H, nc, Lc, hd) view of a (B, nc, Lc, H, hd) tensor on the card."""
    return ssd_scan_cuda(xdt, Bm, Cm, a)
