"""ctypes wrappers of the flash-attention kernels: the forward
(``csrc/flash_attention.cu``) and its backward
(``csrc/flash_attention_bwd.cu``).

For CUDA tensors :func:`flash_attention_cuda` launches the forward kernel
(or raises) inside a ``torch.autograd.Function`` whose forward also saves
each row's log-sum-exp, which the kernel writes, and whose backward
launches the two backward kernels (:func:`flash_attention_bwd_cuda`) on
it.  For CPU tensors it runs the plain version, ``ref.attention_ref``,
under native autograd.  ``launches`` counts forward launches only,
``bwd_launches`` backward launches (two a call: dq, then dk and dv).

Which instance a CUDA call runs, in either direction, is a dispatch on
dtype and width (:func:`instance`): bf16 with hd <= 128 always runs the
tensor-core instance (wgmma fed by TMA, read and written through the
tensors' strides); float32, and any hd > 128, run the CUDA-core instance
in float32 arithmetic on contiguous tensors."""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import build
from ..common import LaunchCounter
from .ref import NEG_INF, attention_ref

launches = LaunchCounter()
bwd_launches = LaunchCounter()

_P, _I = ctypes.c_void_p, ctypes.c_int
DTYPES = (torch.float32, torch.bfloat16)
#: Largest head dim the kernel takes (its largest padded-width instance).
MAX_HEAD_DIM = 256
#: Largest head dim of the bf16 tensor-core instance.
TC_MAX_HEAD_DIM = 128


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _I, _I, _I, _I, _I, ctypes.c_float,
                                           _I, _P]
    lib.flash_attention_tc_launch.restype = ctypes.c_int
    lib.flash_attention_tc_launch.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I,
                                              _I, _I, _I, _P, _I, _I,
                                              ctypes.c_float, _P]
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    lib.flash_attention_bwd_dq_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_dq_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _I, _P]
    lib.flash_attention_bwd_dkv_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_dkv_launch.argtypes = [
        _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        ctypes.c_float, _I, _P]
    for name in ("flash_attention_bwd_tc_dq_launch",
                 "flash_attention_bwd_tc_dkv_launch"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _P, _I, _I, _I, ctypes.c_float, _P]
    return lib


def check_inputs(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4 \
            or v.shape[:3] != k.shape[:3] or v.shape[3] > k.shape[3]:
        raise ValueError(f"q must be (B, H, Sq, hd), k (B, KV, Sk, hd) and v "
                         f"(B, KV, Sk, hd_v) with hd_v <= hd, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or H % k.shape[1]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} "
                         "disagree (batch, head dim, or H % KV != 0)")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {DTYPES}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")


def instance(dtype: torch.dtype, hd: int) -> str:
    """The kernel instance a CUDA call of this dtype and head dim runs:
    ``"tensor-core"`` for bf16 with hd <= 128, else ``"cuda-core"``."""
    return ("tensor-core" if dtype == torch.bfloat16
            and hd <= TC_MAX_HEAD_DIM else "cuda-core")


def _strides(x) -> list[int]:
    """(row, head, batch) strides of a (B, heads, rows, hd) tensor in
    elements, as the TMA maps take them; a dim of extent 1 is never
    stepped, so it gets hd's stride."""
    return [x.stride(d) if x.shape[d] > 1 else x.shape[3] for d in (2, 1, 0)]


def _tma_ready(x):
    """``x`` itself when TMA can read it through its strides (hd
    contiguous, the other strides whole 16-byte steps and none 0, as a
    broadcast cotangent's would be, a 16-byte aligned start), else a
    contiguous copy."""
    if x.stride(3) == 1 and x.data_ptr() % 16 == 0 \
            and all(s > 0 and s % 8 == 0 for s in _strides(x)):
        return x
    return x.clone(memory_format=torch.contiguous_format)


def _tensor_core(lib, q, k, v, lse, causal: bool, window: int):
    """The bf16 instance: reads q, k, v and writes out through their
    strides; hd not a multiple of 8 is zero-padded to one (TMA reads rows
    in 16-byte steps), which adds exact zeros to every dot."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    scale = float(hd**-0.5)
    pad = -hd % 8
    if pad:
        q, k, v = (F.pad(x, (0, pad)) for x in (q, k, v))
    q, k, v = (_tma_ready(x) for x in (q, k, v))
    out = torch.empty_like(q)           # q's strides: a view's, kept
    strides = (ctypes.c_longlong * 12)(*(_strides(q) + _strides(k)
                                         + _strides(v) + _strides(out)))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_tc_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, KV, Sq, Sk, hd + pad, strides, int(causal),
        int(window), scale, stream)
    build.check(lib, err, "flash_attention tensor-core kernel launch")
    return out[..., :hd] if pad else out


def _cuda_core(lib, q, k, v, lse, causal: bool, window: int):
    """The float32-arithmetic instance on contiguous tensors."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    if B * H > 65535:
        raise NotImplementedError(f"flash_attention CUDA-core kernel takes "
                                  f"B * H <= 65535, got {B * H}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, KV, Sq, Sk, hd, int(causal), int(window),
        float(hd**-0.5), int(q.dtype == torch.bfloat16), stream)
    build.check(lib, err, "flash_attention kernel launch")
    return out


def _forward(q, k, v, causal: bool, window: int):
    """One forward launch on CUDA tensors (inputs checked): the output and
    each row's log-sum-exp, (B, H, Sq) float32 (the plain version is
    ``ref.attention_lse_ref``)."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel runs on CUDA tensors, got "
                         f"{q.device}")
    B, H, Sq, hd = q.shape
    Sk, hd_v = k.shape[2], v.shape[3]
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash_attention kernel takes hd <= "
                                  f"{MAX_HEAD_DIM}, got {hd}")
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if q.numel() == 0 or Sk == 0:
        return torch.zeros_like(q[..., :hd_v]), lse.fill_(NEG_INF)
    if hd_v < hd:
        v = F.pad(v, (0, hd - hd_v))
    lib = _lib()
    run = _tensor_core if instance(q.dtype, hd) == "tensor-core" \
        else _cuda_core
    with torch.cuda.device(q.device):
        out = run(lib, q, k, v, lse, causal, window)
    launches.add()
    return out[..., :hd_v], lse


def every_row_sees_a_key(Sq: int, Sk: int, window: int) -> bool:
    """Whether each of Sq query rows has a visible key among Sk (causal or
    not): always without a window; with one, the last row Sq - 1 must lie
    within ``window`` of the last key (row i sees key j > i - window)."""
    return Sk > 0 and (not window or Sq < Sk + window)


def _bwd_tensor_core(lib, q, k, v, out, dout, lse, causal: bool,
                     window: int):
    """The bf16 instance: q, k, v, out and dout read through their strides
    (hd padded to a multiple of 8, and v, out and dout to q's width, with
    zeros, which add nothing to any product), dq, dk and dv written with
    their inputs' strides; lse and D in rows padded to a multiple of 4
    (whole 16-byte copies)."""
    B, H, Sq, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    width = hd + (-hd % 8)
    q, k = (F.pad(x, (0, width - hd)) if width > hd else x for x in (q, k))
    v, out, dout = (F.pad(x, (0, width - hd_v)) if width > hd_v else x
                    for x in (v, out, dout))
    q, k, v, out, dout = (_tma_ready(x) for x in (q, k, v, out, dout))
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    vs = Sq + (-Sq % 4)
    lse = F.pad(lse, (0, vs - Sq)) if vs > Sq else lse.contiguous()
    if lse.data_ptr() % 16:
        lse = lse.clone()
    delta = torch.empty((B, H, vs), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(s for x in (
        q, k, v, out, dout, dq, dk, dv) for s in _strides(x)))
    args = (B, H, KV, Sq, Sk, width, strides, vs, int(causal), int(window),
            float(hd**-0.5), torch.cuda.current_stream(q.device).cuda_stream)
    err = lib.flash_attention_bwd_tc_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *args)
    build.check(lib, err, "flash_attention backward tensor-core dq launch")
    bwd_launches.add()
    err = lib.flash_attention_bwd_tc_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *args)
    build.check(lib, err, "flash_attention backward tensor-core dkv launch")
    bwd_launches.add()
    return dq[..., :hd], dk[..., :hd], dv[..., :hd_v]


def _bwd_cuda_core(lib, q, k, v, out, dout, lse, causal: bool, window: int):
    """The float32-arithmetic instance on contiguous tensors."""
    B, H, Sq, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if max(B * H, B * KV) > 65535:
        raise NotImplementedError(f"flash_attention backward CUDA-core "
                                  f"kernels take B * H <= 65535, got {B * H}")
    q, k, v, out, dout, lse = (x.contiguous()
                               for x in (q, k, v, out, dout, lse))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    args = (B, H, KV, Sq, Sk, hd, hd_v, int(causal), int(window),
            float(hd**-0.5), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    err = lib.flash_attention_bwd_dq_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), dq.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        *args)
    build.check(lib, err, "flash_attention backward dq kernel launch")
    bwd_launches.add()
    err = lib.flash_attention_bwd_dkv_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        *args)
    build.check(lib, err, "flash_attention backward dkv kernel launch")
    bwd_launches.add()
    return dq, dk, dv


def flash_attention_bwd_cuda(q, k, v, out, dout, lse, *, causal: bool = True,
                             window: int = 0):
    """The gradients (dq, dk, dv) of the attention ``out`` = attention(q, k,
    v) for the output cotangent ``dout``, on CUDA tensors (layouts of
    :func:`flash_attention_cuda`; out and dout (B, H, Sq, hd_v)), each in
    its input's dtype.  ``lse`` is each row's log-sum-exp, (B, H, Sq)
    float32, as the forward kernel writes it (``_forward``); nothing
    recomputes it.  Two launches of the
    instance :func:`instance` picks: dq, with D = rowsum(dout * out) into
    float32 scratch, then dk and dv.  The plain version is
    ``ref.attention_bwd_ref``."""
    check_inputs(q, k, v)
    B, H, Sq, hd = q.shape
    KV, Sk, hd_v = k.shape[1], k.shape[2], v.shape[3]
    if out.shape != (B, H, Sq, hd_v) or dout.shape != out.shape:
        raise ValueError(f"out and dout must be {(B, H, Sq, hd_v)}, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)}")
    if lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be {(B, H, Sq)} float32, got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    if hd > MAX_HEAD_DIM:
        raise NotImplementedError(f"flash_attention backward kernels take "
                                  f"hd <= {MAX_HEAD_DIM}, got {hd}")
    if not every_row_sees_a_key(Sq, Sk, window):
        raise NotImplementedError(
            f"flash_attention backward kernels need a visible key for every "
            f"query row (Sq={Sq}, Sk={Sk}, window={window})")
    if q.device.type != "cuda" or lse.device != q.device:
        raise ValueError(f"flash_attention backward kernels run on CUDA "
                         f"tensors, got {q.device} (lse on {lse.device})")
    out, dout = out.to(q.dtype), dout.to(q.dtype)
    if q.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    lib = _bwd_lib()
    run = _bwd_tensor_core if instance(q.dtype, hd) == "tensor-core" \
        else _bwd_cuda_core
    with torch.cuda.device(q.device):
        return run(lib, q, k, v, out, dout, lse, causal, window)


class FlashAttention(torch.autograd.Function):
    """The flash forward kernel with the hand-written backward: forward
    saves q, k, v, the output and each row's log-sum-exp (a re-run under
    remat writes it again); backward launches
    :func:`flash_attention_bwd_cuda` on them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out, lse = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(
            q, k, v, out, dout, lse, causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention_cuda(q, k, v, *, causal: bool = True,
                         window: int = 0) -> torch.Tensor:
    """Causal / sliding-window GQA forward: q (B, H, Sq, hd), k
    (B, KV, Sk, hd) and v (B, KV, Sk, hd_v), hd_v <= hd -> (B, H, Sq, hd_v)
    in q's dtype.  On CUDA, bf16 with hd <= 128 runs the tensor-core
    instance and returns a tensor with q's strides (so the model's
    (B, S, H, hd) views need no copy in or out); float32 and wider heads
    run the CUDA-core instance.  A narrower v (MLA's) is zero-padded to hd
    and the output sliced back: the zero columns add nothing to any
    p @ v.  Differentiable on either device: through :class:`FlashAttention`
    (the backward kernels) on CUDA, native autograd of the plain version
    on the CPU."""
    check_inputs(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    return FlashAttention.apply(q, k, v, causal, window)
