"""LSTM sequence forward: the hand-written Hopper kernel and its plain version.

Replaces the TPU kernels ``_lstm_seq_kernel`` (resident Wh, H <= 512) and
``_lstm_seq_kernel_tiled`` (Wh streamed in column tiles, H > 512) of
``deeplearning4j_tpu/ops/lstm_pallas.py``, reached through ``_fused_seq``.
``csrc/lstm_seq.cu`` covers any H and any B with two variants, chosen by
``plan()`` from (B, H, dtype, the SM count and the shared memory a block
may take):

- ``persistent``: one cooperative launch for all T steps. Each block keeps
  its slice of Wh (8 hidden units x 4 gates, every row of K) in shared
  memory for the whole sequence, holds its units' c and h in registers,
  reads h_prev from L2 each step and crosses into the next step through
  one grid-wide barrier. The grid (H/8 unit groups x batch groups of 8, 16
  or 32 rows) must fit one block on every SM. Every served shape (H=512,
  B 1-64, f32 and bf16) and H=1024 up to B=32 take it.
- ``step_cluster``: shapes whose slice cannot stay resident there (larger
  B or H; H not a multiple of 4): one launch per step, the launch boundary
  as the barrier, the hidden (K) axis split across a thread-block cluster
  of ``cluster_split`` blocks and each block's 8 warps.

What bounds it on an H100: 2*T*B*H*4H operations for one sequence against
about T*B*(4H + 2H) elements moved, so at the served shapes the bound is
the f32 operation rate of the CUDA cores (67 TFLOP/s); the T steps are
serial and a step at small B cannot fill the card, so what a step costs
besides its FMAs (barrier, bringing h_prev to the SMs) sets the time. See
the source for the layouts.

``lstm_seq`` launches the kernel on CUDA tensors and takes
``lstm_seq_plain`` only for tensors on the CPU. ``launches`` counts wrapper
calls that launched the kernel (one per layer per device batch, however
many step launches ``step_cluster`` issues), ``launches_by_variant`` the
same calls by variant.

The shared library is built with ``nvcc`` from ``csrc/`` at first use into
``_build/`` beside it, named by the source's hash, so an edited source is
rebuilt and a clean checkout builds on its first call.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from typing import NamedTuple

import torch

from deeplearning4j_tpu_torch.ops import _build

SOURCE = _build.CSRC / "lstm_seq.cu"

#: kernel launches (wrapper calls that reached the CUDA kernel)
launches = 0
#: the same calls by kernel variant (``plan().variant``)
VARIANTS = ("persistent", "step_cluster")
launches_by_variant = dict.fromkeys(VARIANTS, 0)
_count_lock = threading.Lock()


def _declare(lib):
    lib.lstm_seq_launch.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 11
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.lstm_seq_launch.restype = ctypes.c_int
    lib.lstm_seq_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.lstm_seq_smem_bytes.restype = ctypes.c_int
    lib.lstm_seq_occupancy.argtypes = [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_int)]
    lib.lstm_seq_occupancy.restype = ctypes.c_int
    lib.lstm_seq_split.argtypes = [ctypes.c_int] * 3
    lib.lstm_seq_split.restype = ctypes.c_int
    lib.lstm_seq_error_string.argtypes = [ctypes.c_int]
    lib.lstm_seq_error_string.restype = ctypes.c_char_p


_LIB = _build.Library(SOURCE, _declare)


def build():
    """Compile ``csrc/lstm_seq.cu`` unless built; returns the library path."""
    return _LIB.build()


def reset_launches():
    global launches
    launches = 0
    for k in launches_by_variant:
        launches_by_variant[k] = 0


def cluster_split(b, h, device=None):
    """How many blocks of a cluster split the hidden axis of
    ``step_cluster`` at batch ``b`` and width ``h`` on a CUDA ``device``, as
    the built library computes it (``plan`` mirrors it)."""
    index = _build.device_index(torch.device("cuda" if device is None else device))
    return _LIB.get().lstm_seq_split(b, h, index)


# ---------------------------------------------------------------------------
# the launch plan
# ---------------------------------------------------------------------------

#: shared memory one block may take on sm_90 (bytes)
SMEM_LIMIT = 232_448
#: SMs of an H100 SXM: what plan() assumes when no card is asked
H100_SMS = 132

# the compiled configurations of csrc/lstm_seq.cu (its constants, mirrored)
P_UNITS, P_WARPS, P_RED_LD = 8, 8, 40
P_ROWS_PER_LANE = (1, 2, 4)
S_UNITS, S_ROWS, S_MAX_SPLIT, S_MIN_K = 32, 8, 8, 64


class Plan(NamedTuple):
    """How one call runs: the variant; for ``persistent`` the rows per lane
    ``rt`` (a block takes 8*rt batch rows) and the batch groups, for
    ``step_cluster`` the cluster size ``split``; the grid's blocks (per
    step for ``step_cluster``) and a block's shared memory."""
    variant: str
    rt: int
    groups: int
    split: int
    grid: int
    smem_bytes: int


def k_padded(h):
    """K rows of the persistent layout: H padded to 8 warps of whole
    float4 steps."""
    return P_WARPS * 4 * -(-(h // 4) // P_WARPS)


def persistent_smem(rt, h):
    """Shared memory (bytes) of one persistent block: the Wh slice [KP][32],
    h rows [8 rt][KP + 4] and the warps' partials [8][8 rt][40], f32."""
    kp = k_padded(h)
    return 4 * (kp * 4 * P_UNITS + 8 * rt * (kp + 4) + P_WARPS * 8 * rt * P_RED_LD)


def step_split(b, h, sms):
    """``choose_split`` of csrc/lstm_seq.cu: the cluster size along K,
    doubled while the grid stays within two blocks an SM and each block
    keeps at least 64 rows of Wh."""
    tiles = -(-h // S_UNITS) * -(-b // S_ROWS)
    split = 1
    while split < S_MAX_SPLIT and tiles * split * 2 <= 2 * sms and h // (split * 2) >= S_MIN_K:
        split *= 2
    return split


@functools.lru_cache(maxsize=None)
def plan(b, h, dtype, sms=H100_SMS, smem_limit=SMEM_LIMIT):
    """The launch of one lstm_seq call at batch ``b``, width ``h`` and
    ``dtype`` (float32 or bfloat16; both keep the slice in f32) on a card
    with ``sms`` SMs and ``smem_limit`` bytes of shared memory a block:
    ``persistent`` at the smallest rows per lane whose grid (ceil(H/8) x
    ceil(B / 8 rt) blocks, one an SM: the cooperative launch needs them all
    resident) fits the SMs and whose block fits the shared memory; else
    ``step_cluster``."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm_seq kernel takes float32 or bfloat16, got {dtype}")
    units = -(-h // P_UNITS)
    if h % 4 == 0:
        for rt in P_ROWS_PER_LANE:
            groups = -(-b // (8 * rt))
            smem = persistent_smem(rt, h)
            if units * groups <= sms and smem <= smem_limit:
                return Plan("persistent", rt, groups, 0, units * groups, smem)
    split = step_split(b, h, sms)
    return Plan("step_cluster", 0, 0, split, -(-h // S_UNITS) * -(-b // S_ROWS) * split,
                4 * (S_ROWS * 256 + 8 * 4 * S_ROWS * S_UNITS + 4 * S_ROWS * S_UNITS))


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


_sm_counts = {}


def _sm_count(idx):
    if idx not in _sm_counts:
        _sm_counts[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_counts[idx]


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
    idx = _build.device_index(dev)
    pl = plan(b, hsz, xz.dtype, _sm_count(idx))
    sync = torch.empty(1, dtype=torch.int32, device=dev)  # the grid barrier's counter
    err = lib.lstm_seq_launch(
        VARIANTS.index(pl.variant), pl.rt, pl.split, int(xz.dtype == torch.bfloat16),
        xz.data_ptr(), wh.data_ptr(), None if wp is None else wp.data_ptr(),
        None if maskf is None else maskf.data_ptr(),
        hs.data_ptr(), cs.data_ptr(), h_last.data_ptr(), c_last.data_ptr(),
        h_state.data_ptr(), c_state.data_ptr(), sync.data_ptr(), t_len, b, hsz, idx,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        msg = lib.lstm_seq_error_string(err).decode()
        raise RuntimeError(f"lstm_seq kernel launch failed ({pl}): CUDA error {err} ({msg})")
    with _count_lock:
        launches += 1
        launches_by_variant[pl.variant] += 1
    return hs, cs, h_last, c_last
