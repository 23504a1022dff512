"""ctypes wrappers of the SSD chunk-scan kernels (``csrc/ssd_scan.cu``).

The call runs in three launches: :func:`chunk_states_cuda`,
:func:`state_pass_cuda` and :func:`chunk_scan_cuda`, composed by
:func:`ssd_scan_cuda`.  The stage wrappers take CUDA tensors only and
launch their kernel (or raise); :func:`ssd_scan_cuda` runs the plain
version (``ref.ssd_ref``) for CPU tensors.  ``launches`` counts kernel
launches only, ``LAUNCHES_PER_CALL`` a call."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import build
from ..common import LaunchCounter, refuse_grad
from .ref import ssd_ref

launches = LaunchCounter()
LAUNCHES_PER_CALL = 3

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
#: Largest head dim, state size and chunk length the kernels take (their
#: largest padded-width instances and their shared-memory tile sums).
MAX_HEAD_DIM = 64
MAX_STATE = 128
MAX_CHUNK = 1024


def _lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    lib.ssd_chunk_states_launch.restype = ctypes.c_int
    lib.ssd_chunk_states_launch.argtypes = [_P] * 5 + [_I] * 8 + [_P, _P]
    lib.ssd_state_pass_launch.restype = ctypes.c_int
    lib.ssd_state_pass_launch.argtypes = [_P, _P, _I, _I, _I, _P]
    lib.ssd_chunk_scan_launch.restype = ctypes.c_int
    lib.ssd_chunk_scan_launch.argtypes = [_P] * 6 + [_I] * 8 + [_P, _P]
    return lib


def check_inputs(xdt, Bm, Cm, a) -> None:
    check_shapes(xdt, Bm, Cm, a)
    if xdt.dtype not in DTYPES or a.dtype != xdt.dtype or \
            Bm.dtype not in DTYPES or Cm.dtype != Bm.dtype:
        raise ValueError(f"xdt and a must share one of {DTYPES}, and Bm and "
                         f"Cm one of them too; got {xdt.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}, {a.dtype}")


def check_shapes(xdt, Bm, Cm, a) -> None:
    """The shapes and devices of a call agree (dtypes aside)."""
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
    if not xdt.device == Bm.device == Cm.device == a.device:
        raise ValueError(f"xdt, Bm, Cm, a on {xdt.device}, {Bm.device}, "
                         f"{Cm.device}, {a.device}")


def row_unit(dtype: torch.dtype) -> int:
    """Elements in the 16 bytes a bulk copy moves at a time."""
    return 16 // torch.empty((), dtype=dtype).element_size()


def padded_width(n: int, dtype: torch.dtype) -> int:
    """``n`` rounded up to whole 16-byte rows of ``dtype``."""
    u = row_unit(dtype)
    return -(-n // u) * u


def strides(t: torch.Tensor) -> list[int]:
    """The element strides of t's first four dimensions (0 where a
    dimension has one entry, so its stride is never read)."""
    return [s if n > 1 else 0 for s, n in zip(t.stride()[:4], t.shape[:4])]


def bulk_ready(t: torch.Tensor) -> bool:
    """Whether the kernels can read t's rows through its strides with bulk
    copies: the last dimension contiguous and whole 16-byte units, the
    other strides whole 16-byte steps, the data 16-byte aligned."""
    size = t.element_size()
    return (t.stride(-1) == 1 or t.shape[-1] == 1) \
        and t.shape[-1] * size % 16 == 0 and t.data_ptr() % 16 == 0 \
        and all(s * size % 16 == 0 for s in strides(t))


def operand(t: torch.Tensor, width: int) -> torch.Tensor:
    """t with its last dimension zero-padded to ``width``, as a view where
    the kernels can read it (the model's layouts), else as a contiguous
    copy."""
    if t.shape[-1] < width:
        return F.pad(t, (0, width - t.shape[-1]))
    return t if bulk_ready(t) else t.contiguous()


def _model_layout_y(B, H, nc, Lc, hd, dtype, device) -> torch.Tensor:
    """An output (B, H, nc, Lc, hd) stored as (B, nc, Lc, H, hd), the
    model's layout, so that ``mamba_apply`` reads it with no copy."""
    return torch.empty((B, nc, Lc, H, hd), dtype=dtype,
                       device=device).permute(0, 3, 1, 2, 4)


def _check_stage(xdt, Bm, Cm, a) -> None:
    """The stage kernels' operands: shapes that agree, float32 x and a,
    rows in whole 16-byte units (``ssd_scan_cuda`` pads them), widths
    within the instances."""
    check_shapes(xdt, Bm, Cm, a)
    hd, N = xdt.shape[-1], Bm.shape[-1]
    if a.dtype != torch.float32 or Bm.dtype not in DTYPES or \
            Cm.dtype != Bm.dtype:
        raise ValueError(f"the stage kernels take float32 a and Bm, Cm of "
                         f"one of {DTYPES}, got {a.dtype}, {Bm.dtype}, "
                         f"{Cm.dtype}")
    if xdt.dtype != torch.float32:
        raise ValueError(f"the stage kernels take float32 x, got {xdt.dtype}")
    if hd % 4 or N % row_unit(Bm.dtype) or hd > MAX_HEAD_DIM or \
            N > MAX_STATE or xdt.shape[3] > MAX_CHUNK:
        raise ValueError(f"the stage kernels take hd % 4 == 0, hd <= "
                         f"{MAX_HEAD_DIM}, N a multiple of "
                         f"{row_unit(Bm.dtype)} up to {MAX_STATE} and Lc <= "
                         f"{MAX_CHUNK}, got hd={hd}, N={N}, Lc={xdt.shape[3]}")


#: Why a CUDA call refuses grad (``common.refuse_grad``).
NO_BACKWARD = ("the ssd_scan kernels have no backward yet (ROADMAP item "
               "11j): Mamba2 and Jamba train on the CPU only until then")


def _check_cuda(t: torch.Tensor, *inputs) -> None:
    refuse_grad(NO_BACKWARD, t, *inputs)
    if t.device.type != "cuda":
        raise ValueError(f"the stage kernels run on CUDA tensors, got "
                         f"{t.device}")


def chunk_states_cuda(xdt, Bm, a):
    """Stage 1: the chunk states (B, H, nc, hd, N) and the chunks' totals
    of a (B, H, nc), float32; a block per (b, h, c)."""
    _check_stage(xdt, Bm, Bm, a)
    _check_cuda(xdt, Bm, a)
    B, H, nc, Lc, hd = xdt.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    x, b = operand(xdt, hd), operand(Bm, N)
    states = torch.empty((B, H, nc, hd, N), dtype=torch.float32,
                         device=xdt.device)
    totals = torch.empty((B, H, nc), dtype=torch.float32, device=xdt.device)
    lib = _lib()
    st = (ctypes.c_longlong * 12)(*(strides(x) + strides(b) + strides(a)))
    with torch.cuda.device(xdt.device):
        err = lib.ssd_chunk_states_launch(
            x.data_ptr(), b.data_ptr(), a.data_ptr(), states.data_ptr(),
            totals.data_ptr(), B, H, G, nc, Lc, hd, N,
            int(Bm.dtype == torch.bfloat16), st,
            torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check(lib, err, "ssd_scan chunk_states launch")
    launches.add()
    return states, totals


def state_pass_cuda(states, totals):
    """Stage 2, in place: states (B, H, nc, hd, N) float32 hold the chunk
    states on entry and the state each chunk starts from on return."""
    B, H, nc, hd, N = states.shape
    if states.dtype != torch.float32 or totals.dtype != torch.float32 or \
            not states.is_contiguous() or totals.shape != (B, H, nc) or \
            totals.device != states.device or (hd * N) % 4 or \
            states.data_ptr() % 16:
        raise ValueError("state pass takes contiguous float32 states (B, H, "
                         "nc, hd, N), hd * N a multiple of 4, and totals "
                         "(B, H, nc) on their device")
    _check_cuda(states, totals)
    tot = totals.contiguous()
    lib = _lib()
    with torch.cuda.device(states.device):
        err = lib.ssd_state_pass_launch(
            states.data_ptr(), tot.data_ptr(), B * H, nc, hd * N,
            torch.cuda.current_stream(states.device).cuda_stream)
    build.check(lib, err, "ssd_scan state_pass launch")
    launches.add()
    return states


def chunk_scan_cuda(xdt, Bm, Cm, a, starts, out=None):
    """Stage 3: y (B, H, nc, Lc, hd) float32 from the states the chunks
    start from; a block per (b, h, c, 64-row query tile).  y goes to
    ``out`` (float32, hd contiguous, any strides) or to a new tensor in
    the model's (B, nc, Lc, H, hd) layout."""
    _check_stage(xdt, Bm, Cm, a)
    B, H, nc, Lc, hd = xdt.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    if not starts.is_contiguous() or starts.dtype != torch.float32 or \
            starts.shape != (B, H, nc, hd, N):
        raise ValueError("chunk scan takes contiguous float32 starts "
                         f"{(B, H, nc, hd, N)}, got {tuple(starts.shape)}")
    if out is None:
        out = _model_layout_y(B, H, nc, Lc, hd, torch.float32, xdt.device)
    elif out.dtype != torch.float32 or out.shape != xdt.shape or \
            out.stride(-1) != 1 or out.data_ptr() % 8 or \
            any(s % 2 for s in strides(out)):
        raise ValueError("chunk scan writes a float32 out shaped like xdt, "
                         "hd contiguous, rows 8-byte aligned")
    _check_cuda(xdt, Bm, Cm, a, starts)
    x, b, c = operand(xdt, hd), operand(Bm, N), operand(Cm, N)
    lib = _lib()
    st = (ctypes.c_longlong * 20)(*(strides(x) + strides(b) + strides(c)
                                    + strides(a) + strides(out)))
    with torch.cuda.device(xdt.device):
        err = lib.ssd_chunk_scan_launch(
            x.data_ptr(), b.data_ptr(), c.data_ptr(), a.data_ptr(),
            starts.data_ptr(), out.data_ptr(), B, H, G, nc, Lc, hd, N,
            int(Bm.dtype == torch.bfloat16), st,
            torch.cuda.current_stream(xdt.device).cuda_stream)
    build.check(lib, err, "ssd_scan chunk_scan launch")
    launches.add()
    return out


def ssd_scan_cuda(xdt, Bm, Cm, a) -> torch.Tensor:
    """The SSD chunk scan from a zero state: xdt (B, H, nc, Lc, hd), Bm, Cm
    (B, G, nc, Lc, N) with head h reading group h // (H // G), a (B, H, nc,
    Lc) -> y (B, H, nc, Lc, hd) in xdt's dtype, stored in the model's
    (B, nc, Lc, H, hd) layout.  Inputs are read through their strides;
    bfloat16 x and a are widened to float32 (exactly) and hd and N are
    zero-padded to whole 16-byte rows, each by a copy, where needed."""
    check_inputs(xdt, Bm, Cm, a)
    if xdt.device.type == "cpu":
        return ssd_ref(xdt, Bm, Cm, a)
    refuse_grad(NO_BACKWARD, xdt, Bm, Cm, a)
    B, H, nc, Lc, hd = xdt.shape
    N = Bm.shape[-1]
    if hd > MAX_HEAD_DIM or N > MAX_STATE or Lc > MAX_CHUNK:
        raise NotImplementedError(
            f"ssd_scan kernel takes hd <= {MAX_HEAD_DIM}, N <= {MAX_STATE} "
            f"and Lc <= {MAX_CHUNK}, got hd={hd}, N={N}, Lc={Lc}")
    if xdt.device.type != "cuda":
        raise ValueError(f"ssd_scan kernel runs on CUDA tensors, got "
                         f"{xdt.device}")
    y = _model_layout_y(B, H, nc, Lc, hd, xdt.dtype, xdt.device)
    if y.numel() == 0:
        return y
    hd_p, N_p = padded_width(hd, torch.float32), padded_width(N, Bm.dtype)
    x, a = operand(xdt.float(), hd_p), a.float()
    b, c = operand(Bm, N_p), operand(Cm, N_p)
    out = y if hd_p == hd and y.dtype == torch.float32 else \
        _model_layout_y(B, H, nc, Lc, hd_p, torch.float32, xdt.device)
    states, totals = chunk_states_cuda(x, b, a)
    chunk_scan_cuda(x, b, c, a, state_pass_cuda(states, totals), out=out)
    if out is not y:
        y.copy_(out[..., :hd])
    return y
