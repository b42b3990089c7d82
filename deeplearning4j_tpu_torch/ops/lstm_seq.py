"""LSTM sequence forward: the hand-written Hopper kernel and its plain version.

Replaces the TPU kernels ``_lstm_seq_kernel`` (resident Wh, H <= 512) and
``_lstm_seq_kernel_tiled`` (Wh streamed in column tiles, H > 512) of
``deeplearning4j_tpu/ops/lstm_pallas.py``, reached through ``_fused_seq``.
One CUDA kernel (``csrc/lstm_seq.cu``) covers any H and any B.

What bounds it on an H100: 2*T*B*H*4H operations for one sequence against
about T*B*(4H + 2H) elements moved, so at the served shapes (H=512, B up to
64) the bound is the f32 operation rate of the CUDA cores (67 TFLOP/s).
The T steps are serial and one step at small B cannot fill the card, so
per-step latency sets the time in practice. The design answers the serial
dependency with one launch per step (the launch boundary is the grid-wide
barrier); a block owns 32 hidden units by 8 batch rows and computes all
four gate columns of its units, so the gate math stays in the tile; the
hidden (K) axis of the product is split across a thread-block cluster of
up to 8 blocks (more SMs busy at small B) and across each block's 8 warps,
with the partial sums meeting in shared and distributed shared memory.
See the source for the layout.

``lstm_seq`` launches the kernel on CUDA tensors and takes
``lstm_seq_plain`` only for tensors on the CPU. ``launches`` counts wrapper
calls that launched the kernel: one per layer per device batch, however
many step launches the C side issues.

The shared library is built with ``nvcc`` from ``csrc/`` at first use into
``_build/`` beside it, named by the source's hash, so an edited source is
rebuilt and a clean checkout builds on its first call.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from deeplearning4j_tpu_torch.ops import _build

SOURCE = _build.CSRC / "lstm_seq.cu"

#: kernel launches (wrapper calls that reached the CUDA kernel)
launches = 0
_count_lock = threading.Lock()

_ENTRY_ARGS = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _declare(lib):
    for name in ("lstm_seq_f32", "lstm_seq_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = _ENTRY_ARGS
        fn.restype = ctypes.c_int
    lib.lstm_seq_split.argtypes = [ctypes.c_int] * 3
    lib.lstm_seq_split.restype = ctypes.c_int
    lib.lstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.lstm_seq_error_string.restype = ctypes.c_char_p


_LIB = _build.Library(SOURCE, _declare)


def build():
    """Compile ``csrc/lstm_seq.cu`` unless built; returns the library path."""
    return _LIB.build()


def cluster_split(b, h, device=None):
    """How many blocks of a cluster split the hidden axis at batch ``b``
    and width ``h`` on a CUDA ``device`` (the kernel picks it from B, H and
    the SM count)."""
    index = _build.device_index(torch.device("cuda" if device is None else device))
    return _LIB.get().lstm_seq_split(b, h, index)


def lstm_seq_plain(xz, wh, h0, c0, wp=None, mask=None):
    """The contract of ``lstm_seq`` as a PyTorch time loop.

    xz [T,B,4H] (x.Wx + b, time-major, gates i|f|g|o), wh [H,4H], h0/c0
    [B,H], wp [3,H] (i|f|o peepholes) or None, mask [T,B] (1 = valid) or
    None. State is carried in f32 (f64 stays f64); h meets Wh in Wh's
    dtype. Returns hs, cs [T,B,H] and hT, cT [B,H] in xz's dtype."""
    t_len, _, four_h = xz.shape
    hsz = four_h // 4
    sd = torch.promote_types(xz.dtype, torch.float32)
    h, c = h0.to(sd), c0.to(sd)
    whf = wh.to(sd)
    wpf = None if wp is None else wp.to(sd)
    mf = None if mask is None else mask.to(sd)
    hs, cs = [], []
    for t in range(t_len):
        z = xz[t].to(sd) + torch.matmul(h.to(wh.dtype).to(sd), whf)
        zi, zf, zg, zo = z.split(hsz, dim=-1)
        if wpf is not None:
            zi = zi + wpf[0] * c
            zf = zf + wpf[1] * c
        i, f = torch.sigmoid(zi), torch.sigmoid(zf)
        c_new = f * c + i * torch.tanh(zg)
        if wpf is not None:
            zo = zo + wpf[2] * c_new
        h_new = torch.sigmoid(zo) * torch.tanh(c_new)
        if mf is not None:
            m = mf[t][:, None]
            h_new = m * h_new + (1 - m) * h
            c_new = m * c_new + (1 - m) * c
        h, c = h_new, c_new
        hs.append(h)
        cs.append(c)
    out = xz.dtype
    return (torch.stack(hs).to(out), torch.stack(cs).to(out), h.to(out),
            c.to(out))


def _check(xz, wh, h0, c0, wp, mask):
    if xz.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm_seq kernel takes float32 or bfloat16, got {xz.dtype}")
    if xz.dim() != 3 or xz.shape[2] % 4:
        raise ValueError(f"xz must be [T, B, 4H], got {tuple(xz.shape)}")
    t_len, b, four_h = xz.shape
    hsz = four_h // 4
    if t_len < 1 or b < 1:
        raise ValueError(f"lstm_seq needs T >= 1 and B >= 1, got {tuple(xz.shape)}")
    want = {"wh": (wh, (hsz, four_h)), "h0": (h0, (b, hsz)), "c0": (c0, (b, hsz))}
    if wp is not None:
        want["wp"] = (wp, (3, hsz))
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    for name, t in (("xz", xz), ("wh", wh), ("wp", wp)):
        if t is None:
            continue
        if t.device != xz.device:
            raise ValueError(f"{name} is on {t.device}, xz on {xz.device}")
        if t.dtype != xz.dtype:
            raise TypeError(f"{name} is {t.dtype}, xz is {xz.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("h0", h0), ("c0", c0), ("mask", mask)):
        if t is not None and t.device != xz.device:
            raise ValueError(f"{name} is on {t.device}, xz on {xz.device}")
    if mask is not None and tuple(mask.shape) != (t_len, b):
        raise ValueError(f"mask must be [T, B] = {(t_len, b)}, got {tuple(mask.shape)}")


def refuse_autograd(device_type, *tensors):
    """Raise when the CUDA kernel would be asked for a gradient: it has no
    backward yet, and its outputs carry no ``grad_fn``, so the graph would
    be cut without a word. The CPU plain version stays differentiable."""
    if device_type != "cuda" or not torch.is_grad_enabled():
        return
    if any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            "lstm_seq: the CUDA kernel has no backward yet (ROADMAP queue 1, "
            "\"the LSTM backward\"); run it under torch.no_grad() or "
            "inference_mode, or train a recurrent net on the CPU")


def lstm_seq(xz, wh, h0, c0, wp=None, mask=None):
    """LSTM over T steps: hs, cs [T,B,H] and hT, cT [B,H] (see
    ``lstm_seq_plain`` for the contract). CUDA tensors launch the Hopper
    kernel (f32 or bf16 xz/wh/wp, h0/c0 any float dtype); CPU tensors take
    the plain version. On CUDA tensors it refuses autograd (see
    ``refuse_autograd``)."""
    global launches
    if xz.device.type == "cpu":
        return lstm_seq_plain(xz, wh, h0, c0, wp=wp, mask=mask)
    if xz.device.type != "cuda":
        raise ValueError(f"lstm_seq runs on cuda or cpu tensors, got {xz.device}")
    refuse_autograd(xz.device.type, xz, wh, h0, c0, wp)
    _check(xz, wh, h0, c0, wp, mask)
    lib = _LIB.get()
    t_len, b, four_h = xz.shape
    hsz = four_h // 4
    dev = xz.device
    hs = torch.empty((t_len, b, hsz), dtype=xz.dtype, device=dev)
    cs = torch.empty_like(hs)
    h_last = torch.empty((b, hsz), dtype=xz.dtype, device=dev)
    c_last = torch.empty_like(h_last)
    h_state = torch.empty((2, b, hsz), dtype=torch.float32, device=dev)
    h_state[0].copy_(h0)
    c_state = c0.to(dtype=torch.float32, copy=True).contiguous()
    maskf = None if mask is None else mask.to(torch.float32).contiguous()
    fn = lib.lstm_seq_f32 if xz.dtype == torch.float32 else lib.lstm_seq_bf16
    err = fn(xz.data_ptr(), wh.data_ptr(),
             None if wp is None else wp.data_ptr(),
             None if maskf is None else maskf.data_ptr(),
             hs.data_ptr(), cs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
             h_state.data_ptr(), c_state.data_ptr(), t_len, b, hsz,
             _build.device_index(dev),
             torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.lstm_seq_error_string(err).decode()
        raise RuntimeError(f"lstm_seq kernel launch failed: CUDA error {err} ({msg})")
    with _count_lock:
        launches += 1
    return hs, cs, h_last, c_last
