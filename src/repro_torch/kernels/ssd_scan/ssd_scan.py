"""ctypes wrappers of the SSD chunk-scan kernels (``csrc/ssd_scan.cu``,
forward; ``csrc/ssd_scan_bwd.cu``, backward).

The forward runs in three launches: :func:`chunk_states_cuda`,
:func:`state_pass_cuda` and :func:`chunk_scan_cuda`, composed by
:func:`ssd_scan_cuda`.  The backward runs in four:
:func:`chunk_dstates_cuda`, :func:`state_pass_bwd_cuda`,
:func:`chunk_scan_bwd_cuda` and :func:`group_sum_cuda`, composed by
:func:`ssd_scan_bwd_cuda`.  :class:`SSDScan` ties them together for
autograd, and :func:`ssd_scan_cuda` goes through it whenever a gradient is
asked for.  The stage wrappers take CUDA tensors only and launch their
kernel (or raise); :class:`SSDScan` runs the plain stages (``ref.py``) for
CPU tensors, and :func:`ssd_scan_cuda` without a gradient the plain
recurrence (``ref.ssd_ref``).  ``launches`` and ``bwd_launches`` count
kernel launches only, ``LAUNCHES_PER_CALL`` and ``LAUNCHES_PER_BWD`` a
call."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import build
from ..common import LaunchCounter, refuse_grad
from . import ref
from .ref import ssd_ref

launches = LaunchCounter()
bwd_launches = LaunchCounter()
LAUNCHES_PER_CALL = 3
#: dstates, the reverse state pass, the chunk scan backward, the group sum.
LAUNCHES_PER_BWD = 4

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


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd")
    lib.ssd_chunk_dstates_launch.restype = ctypes.c_int
    lib.ssd_chunk_dstates_launch.argtypes = [_P] * 4 + [_I] * 8 + [_P, _P]
    lib.ssd_state_pass_bwd_launch.restype = ctypes.c_int
    lib.ssd_state_pass_bwd_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.ssd_chunk_scan_bwd_launch.restype = ctypes.c_int
    lib.ssd_chunk_scan_bwd_launch.argtypes = [_P] * 13 + [_I] * 8 + [_P, _P]
    lib.ssd_group_sum_launch.restype = ctypes.c_int
    lib.ssd_group_sum_launch.argtypes = [_P] * 4 + [_I] * 7 + [_P, _P]
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


def _model_layout(shape, dtype, device, order) -> torch.Tensor:
    """A tensor of ``shape`` stored in the dimension order ``order`` (the
    model's layout: chunks before heads)."""
    store = torch.empty([shape[i] for i in order], dtype=dtype,
                        device=device)
    return store.permute([order.index(i) for i in range(len(shape))])


def _model_layout_y(B, H, nc, Lc, hd, dtype, device) -> torch.Tensor:
    """An output (B, H, nc, Lc, hd) stored as (B, nc, Lc, H, hd), the
    model's layout, so that ``mamba_apply`` reads it with no copy."""
    return _model_layout((B, H, nc, Lc, hd), dtype, device, (0, 2, 3, 1, 4))


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


#: Why a stage wrapper refuses grad (``common.refuse_grad``).
STAGE_NO_GRAD = ("an ssd_scan stage kernel has no backward of its own; "
                 "ssd_scan_cuda is the differentiable entry (SSDScan)")


def _check_cuda(t: torch.Tensor, *inputs) -> None:
    refuse_grad(STAGE_NO_GRAD, t, *inputs)
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


def _operands(xdt, Bm, Cm, a):
    """The kernels' operands: x float32 with hd zero-padded to whole
    16-byte rows, a float32, B and C with N padded likewise (views where
    the kernels can read them, else copies)."""
    hd_p = padded_width(xdt.shape[-1], torch.float32)
    N_p = padded_width(Bm.shape[-1], Bm.dtype)
    return (operand(xdt.float(), hd_p), operand(Bm, N_p), operand(Cm, N_p),
            a.float())


def _forward(x, b, c, a, out) -> tuple[torch.Tensor, torch.Tensor]:
    """The three forward stages on padded operands, y into ``out``
    (float32); returns the states the chunks start from and the chunks'
    totals of a.  Kernels on CUDA tensors, the plain stages on the CPU."""
    if x.device.type == "cpu":
        states, totals = ref.chunk_states_ref(x, b, a)
        starts = ref.state_pass_ref(states, totals)
        out.copy_(ref.chunk_scan_ref(x, b, c, a, starts))
        return starts, totals
    states, totals = chunk_states_cuda(x, b, a)
    starts = state_pass_cuda(states, totals)
    chunk_scan_cuda(x, b, c, a, starts, out=out)
    return starts, totals


def ssd_scan_cuda(xdt, Bm, Cm, a) -> torch.Tensor:
    """The SSD chunk scan from a zero state: xdt (B, H, nc, Lc, hd), Bm, Cm
    (B, G, nc, Lc, N) with head h reading group h // (H // G), a (B, H, nc,
    Lc) -> y (B, H, nc, Lc, hd) in xdt's dtype, stored in the model's
    (B, nc, Lc, H, hd) layout.  Inputs are read through their strides;
    bfloat16 x and a are widened to float32 (exactly) and hd and N are
    zero-padded to whole 16-byte rows, each by a copy, where needed.
    Differentiable: with grad on and an input that requires it, the call
    goes through :class:`SSDScan` (the backward kernels on CUDA, the plain
    stages on the CPU); otherwise CPU tensors run ``ref.ssd_ref``."""
    check_inputs(xdt, Bm, Cm, a)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xdt, Bm, Cm, a)):
        return SSDScan.apply(xdt, Bm, Cm, a)
    if xdt.device.type == "cpu":
        return ssd_ref(xdt, Bm, Cm, a)
    return _scan(xdt, Bm, Cm, a)[0]


def _scan(xdt, Bm, Cm, a):
    """The forward on any device: y in the model's layout, and what the
    backward reads, (x, b, c, a, starts, totals, out), on padded operands
    (``out`` the float32 y, hd padded)."""
    B, H, nc, Lc, hd = xdt.shape
    N = Bm.shape[-1]
    if xdt.device.type != "cpu":
        if hd > MAX_HEAD_DIM or N > MAX_STATE or Lc > MAX_CHUNK:
            raise NotImplementedError(
                f"ssd_scan kernel takes hd <= {MAX_HEAD_DIM}, N <= "
                f"{MAX_STATE} and Lc <= {MAX_CHUNK}, got hd={hd}, N={N}, "
                f"Lc={Lc}")
        if xdt.device.type != "cuda":
            raise ValueError(f"ssd_scan kernel runs on CUDA tensors, got "
                             f"{xdt.device}")
    y = _model_layout_y(B, H, nc, Lc, hd, xdt.dtype, xdt.device)
    x, b, c, af = _operands(xdt, Bm, Cm, a)
    hd_p = x.shape[-1]
    out = y if hd_p == hd and y.dtype == torch.float32 else \
        _model_layout_y(B, H, nc, Lc, hd_p, torch.float32, xdt.device)
    if y.numel() == 0:
        return y, None
    starts, totals = _forward(x, b, c, af, out)
    if out is not y:
        y.copy_(out[..., :hd])
    return y, (x, b, c, af, starts, totals, out)


class SSDScan(torch.autograd.Function):
    """The chunk scan with its hand-written backward: forward runs the
    three stages and saves the padded operands, the states the chunks
    start from (stage 2's output), the chunks' totals of a and the
    float32 output; backward runs :func:`ssd_scan_bwd_cuda` on them (on
    CPU tensors, the plain ``ref.ssd_bwd_ref``) and returns dxdt, dBm, dCm
    and da in the inputs' dtypes and shapes, the padding undone."""

    @staticmethod
    def forward(ctx, xdt, Bm, Cm, a):
        y, saved = _scan(xdt, Bm, Cm, a)
        ctx.meta = (xdt.dtype, Bm.dtype, a.dtype, xdt.shape[-1], Bm.shape[-1],
                    saved is None)
        if saved is not None:
            ctx.save_for_backward(*saved)
        return y

    @staticmethod
    def backward(ctx, dy):
        xdt_dtype, b_dtype, a_dtype, hd, N, empty = ctx.meta
        if empty:                   # an empty output: zero gradients
            return None, None, None, None
        x, b, c, a, starts, totals, out = ctx.saved_tensors
        g = operand(dy.float(), x.shape[-1])
        if x.device.type == "cpu":
            dx, dB, dC, da = ref.ssd_bwd_ref(x, b, c, a, starts, g)
        else:
            dx, dB, dC, da = ssd_scan_bwd_cuda(x, b, c, a, g, out, starts,
                                               totals)
        return (dx[..., :hd].to(xdt_dtype), dB[..., :N].to(b_dtype),
                dC[..., :N].to(b_dtype), da.to(a_dtype))


def _check_bwd(x, b, c, a, dy, y) -> None:
    _check_stage(x, b, c, a)
    for name, t in (("dy", dy), ("y", y)):
        if t.shape != x.shape or t.dtype != torch.float32 or \
                not bulk_ready(t) or t.device != x.device:
            raise ValueError(f"{name} must be float32 {tuple(x.shape)} on "
                             f"{x.device}, rows read by bulk copies; got "
                             f"{tuple(t.shape)} {t.dtype}")


def chunk_dstates_cuda(dy, Cm, a):
    """Backward stage 1: dS (B, H, nc, hd, N) float32, dS_c = dy^T (C o
    exp(cs)), a block per (b, h, c).  dy float32 with rows of whole
    16-byte units, like the forward's x."""
    _check_stage(dy, Cm, Cm, a)
    _check_cuda(dy, Cm, a)
    B, H, nc, Lc, hd = dy.shape
    G, N = Cm.shape[1], Cm.shape[-1]
    dstates = torch.empty((B, H, nc, hd, N), dtype=torch.float32,
                          device=dy.device)
    lib = _bwd_lib()
    st = (ctypes.c_longlong * 12)(*(strides(dy) + strides(Cm) + strides(a)))
    with torch.cuda.device(dy.device):
        err = lib.ssd_chunk_dstates_launch(
            dy.data_ptr(), Cm.data_ptr(), a.data_ptr(), dstates.data_ptr(),
            B, H, G, nc, Lc, hd, N, int(Cm.dtype == torch.bfloat16), st,
            torch.cuda.current_stream(dy.device).cuda_stream)
    build.check(lib, err, "ssd_scan_bwd chunk_dstates launch")
    bwd_launches.add()
    return dstates


def state_pass_bwd_cuda(dstates, starts, totals):
    """Backward stage 2, the reverse state pass, a block per (b, h):
    ``dstates`` (B, H, nc, hd, N) float32 holds dS on entry and Q on
    return, Q_c the gradient reaching the state chunk c ends in; returns
    (Q, end), end (B, H, nc) = <Q_c, S_{c+1}>, S_{c+1} = starts[c + 1] (0
    for the last chunk)."""
    B, H, nc, hd, N = dstates.shape
    for t in (dstates, starts):
        if t.dtype != torch.float32 or not t.is_contiguous() or \
                t.shape != dstates.shape or t.device != dstates.device:
            raise ValueError("the reverse state pass takes contiguous "
                             "float32 dstates and starts (B, H, nc, hd, N) "
                             "on one device")
    if totals.shape != (B, H, nc) or totals.dtype != torch.float32 or \
            (hd * N) % 4 or hd * N > 8192:
        raise ValueError("the reverse state pass takes float32 totals (B, "
                         "H, nc) and hd * N a multiple of 4 up to 8192")
    _check_cuda(dstates, starts, totals)
    end = torch.empty((B, H, nc), dtype=torch.float32, device=dstates.device)
    tot = totals.contiguous()
    lib = _bwd_lib()
    with torch.cuda.device(dstates.device):
        err = lib.ssd_state_pass_bwd_launch(
            dstates.data_ptr(), starts.data_ptr(), tot.data_ptr(),
            end.data_ptr(), B * H, nc, hd * N,
            torch.cuda.current_stream(dstates.device).cuda_stream)
    build.check(lib, err, "ssd_scan_bwd state_pass launch")
    bwd_launches.add()
    return dstates, end


def state_width(N: int) -> int:
    """Columns of the per-head rows of dB and dC that stage 3 writes: the
    N of the kernel instance (32, 64 or 128)."""
    return 32 if N <= 32 else 64 if N <= 64 else 128


def chunk_scan_bwd_cuda(x, Bm, Cm, a, dy, y, starts, q, end):
    """Backward stage 3, a block per (b, h, c): dx (like x, float32, in
    the model's layout), dB and dC per head (B, H, nc, Lc, state_width(N))
    float32 (columns past N unspecified), and da (like a, float32, in the
    model's layout).  ``y`` is the forward's float32 output, ``starts``
    and ``q`` (B, H, nc, hd, N) stages 2's, ``end`` the reverse pass's
    end-state products."""
    _check_bwd(x, Bm, Cm, a, dy, y)
    B, H, nc, Lc, hd = x.shape
    G, N = Bm.shape[1], Bm.shape[-1]
    for t in (starts, q):
        if t.shape != (B, H, nc, hd, N) or t.dtype != torch.float32 or \
                not t.is_contiguous():
            raise ValueError(f"starts and q must be contiguous float32 "
                             f"{(B, H, nc, hd, N)}")
    if end.shape != (B, H, nc) or end.dtype != torch.float32:
        raise ValueError(f"end must be float32 {(B, H, nc)}")
    _check_cuda(x, Bm, Cm, a, dy, y, starts, q, end)
    dev = x.device
    dx = _model_layout_y(B, H, nc, Lc, hd, torch.float32, dev)
    da = _model_layout((B, H, nc, Lc), torch.float32, dev, (0, 2, 3, 1))
    width = state_width(N)
    dBh = torch.empty((B, H, nc, Lc, width), dtype=torch.float32, device=dev)
    dCh = torch.empty_like(dBh)
    e = end.contiguous()
    lib = _bwd_lib()
    st = (ctypes.c_longlong * 32)(*(
        strides(x) + strides(Bm) + strides(Cm) + strides(a) + strides(dy)
        + strides(y) + strides(dx) + strides(da)))
    with torch.cuda.device(dev):
        err = lib.ssd_chunk_scan_bwd_launch(
            x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), a.data_ptr(),
            dy.data_ptr(), y.data_ptr(), starts.data_ptr(), q.data_ptr(),
            e.data_ptr(), dx.data_ptr(), dBh.data_ptr(), dCh.data_ptr(),
            da.data_ptr(), B, H, G, nc, Lc, hd, N,
            int(Bm.dtype == torch.bfloat16), st,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan_bwd chunk_scan launch")
    bwd_launches.add()
    return dx, dBh, dCh, da


def group_sum_cuda(dBh, dCh, G: int, N: int, dtype):
    """Backward stage 4: dB and dC (B, G, nc, Lc, N) in ``dtype``, in the
    model's layout, each the sum over its group's heads, in head order, of
    stage 3's per-head rows."""
    B, H, nc, Lc, width = dBh.shape
    if dCh.shape != dBh.shape or dBh.dtype != torch.float32 or \
            dCh.dtype != torch.float32 or not dBh.is_contiguous() or \
            not dCh.is_contiguous() or width != state_width(N) or \
            G < 1 or H % G or dtype not in DTYPES:
        raise ValueError("group sum takes stage 3's contiguous float32 "
                         f"rows of width state_width(N), G dividing H and "
                         f"an output dtype of {DTYPES}")
    _check_cuda(dBh, dCh)
    dev = dBh.device
    order = (0, 2, 3, 1, 4)
    dB, dC = (_model_layout((B, G, nc, Lc, N), dtype, dev, order)
              for _ in range(2))
    lib = _bwd_lib()
    st = (ctypes.c_longlong * 8)(*(strides(dB) + strides(dC)))
    with torch.cuda.device(dev):
        err = lib.ssd_group_sum_launch(
            dBh.data_ptr(), dCh.data_ptr(), dB.data_ptr(), dC.data_ptr(), B,
            H, G, nc, Lc, N, int(dtype == torch.bfloat16), st,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, "ssd_scan_bwd group_sum launch")
    bwd_launches.add()
    return dB, dC


def ssd_scan_bwd_cuda(x, Bm, Cm, a, dy, y, starts, totals):
    """The backward of the chunk scan on the forward's padded operands
    (``_operands``): dy and y (B, H, nc, Lc, hd) float32, ``starts`` and
    ``totals`` as the forward's stages 1 and 2 left them.  Four launches;
    returns (dx, dB, dC, da), dx and da float32, dB and dC in Bm's dtype,
    per group.  The plain version is ``ref.ssd_bwd_ref``."""
    dstates = chunk_dstates_cuda(dy, Cm, a)
    q, end = state_pass_bwd_cuda(dstates, starts, totals)
    dx, dBh, dCh, da = chunk_scan_bwd_cuda(x, Bm, Cm, a, dy, y, starts, q,
                                           end)
    dB, dC = group_sum_cuda(dBh, dCh, Bm.shape[1], Bm.shape[-1], Bm.dtype)
    return dx, dB, dC, da
