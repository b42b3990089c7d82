"""LSTM sequence op: the hand-written Hopper forward kernel, its plain version,
and the backward.

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

The backward is ``lstm_seq_bwd``, a port of the JAX package's
``lstm_pallas._bwd``, which is XLA there, not Pallas: PyTorch on both
devices. When a gradient is asked for, ``lstm_seq`` runs through an
``autograd.Function`` whose forward is the kernel (CUDA tensors) or the
plain version (CPU tensors) and whose backward is ``lstm_seq_bwd``. All the
forward's states are known in the backward, so the gate recompute is one
``[T*B, H] x [H, 4H]`` product and elementwise math over every step at
once, and ``dWh`` one product after the loop; only the dh/dc recurrence
runs step by step (a few elementwise launches and ``dh_prev = dz . Wh^T``
a step).

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

from deeplearning4j_tpu_torch.ops import _build, _plans

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
#: shared memory of one step_cluster block (bytes; static in the source)
STEP_SMEM = 4 * (S_ROWS * 256 + 8 * 4 * S_ROWS * S_UNITS + 4 * S_ROWS * S_UNITS)
#: the cluster sizes step_cluster is compiled to take
S_SPLITS = (1, 2, 4, 8)


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
                STEP_SMEM)


def config_of(pl):
    """The tunable fields of a plan: the variant and its rows per lane or
    cluster size."""
    if pl.variant == "persistent":
        return {"variant": "persistent", "rt": pl.rt}
    return {"variant": "step_cluster", "split": pl.split}


def configured(b, h, dtype, sms, config, occupancy=None):
    """The plan ``config`` gives a call at batch ``b`` and width ``h``, or
    the reason it is refused: a variant or size the library has not
    compiled, ``persistent`` on H off a multiple of 4, shared memory above
    ``SMEM_LIMIT``, a ``persistent`` grid that cannot be co-resident (the
    cooperative launch refuses one: at most ``occupancy(rt)`` blocks an SM
    where the card is asked, else one, ``plan()``'s arithmetic), or a
    ``step_cluster`` split that leaves a rank no rows of K."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"lstm_seq kernel takes float32 or bfloat16, got {dtype}")
    variant = config.get("variant") if isinstance(config, dict) else None
    try:
        if variant == "persistent":
            rt = int(config["rt"])
            if rt not in P_ROWS_PER_LANE:
                return f"not compiled: persistent takes rt in {list(P_ROWS_PER_LANE)}, not {rt}"
            if h % 4:
                return f"alignment: persistent needs H % 4 == 0, H is {h}"
            smem = persistent_smem(rt, h)
            if smem > SMEM_LIMIT:
                return f"smem: {smem} B exceeds the {SMEM_LIMIT} B a block may take"
            groups = -(-b // (8 * rt))
            grid = -(-h // P_UNITS) * groups
            per_sm = 1 if occupancy is None else int(occupancy(rt))
            if grid > sms * per_sm:
                return (f"co-residency: a cooperative grid of {grid} blocks exceeds {sms} SMs "
                        f"x {per_sm} resident")
            return Plan("persistent", rt, groups, 0, grid, smem)
        if variant == "step_cluster":
            split = int(config["split"])
            if split not in S_SPLITS:
                return f"not compiled: step_cluster takes split in {list(S_SPLITS)}, not {split}"
            if (split - 1) * -(-h // split) >= h:
                return f"redundant: split {split} leaves a rank no rows of K at H={h}"
            return Plan("step_cluster", 0, 0, split, -(-h // S_UNITS) * -(-b // S_ROWS) * split,
                        STEP_SMEM)
    except (KeyError, TypeError, ValueError):
        pass
    return f"config: needs variant persistent (rt) or step_cluster (split), got {config}"


def _resolve(db, key, occupancy=None):
    t, b, h, dtype, sms = key
    dt = _plans.DTYPES[dtype]
    default = plan(b, h, dt, sms)
    if db is not None:
        cfg = db.lookup("lstm", (t, b, h), dtype)
        if cfg is not None:
            pl = configured(b, h, dt, sms, cfg, occupancy)
            if isinstance(pl, Plan):
                return config_of(pl), pl
    return config_of(default), default


def _configured_at(key, config):
    t, b, h, dtype, sms = key
    return configured(b, h, _plans.DTYPES[dtype], sms, config)


#: the plans of this library's calls, per call key and tuning-DB binding
PLANS = _plans.PlanCache("lstm_seq", _resolve, _configured_at)


def plan_key(t, b, h, dtype, sms=H100_SMS):
    """The key ``PLANS`` keeps a call's plan under."""
    return (int(t), int(b), int(h), _plans.dtype_name(dtype), int(sms))


def launch_plan(t, b, h, dtype, sms=H100_SMS, occupancy=None):
    """The plan a launch takes: ``plan()``'s, or with a tuning DB bound the
    tuned config of the call's bucket (kernel id ``lstm``, shape (T, B,
    H)) where it validates here (``occupancy``: rt -> persistent blocks an
    SM, from the card); resolved once per call key and binding."""
    return PLANS.get(plan_key(t, b, h, dtype, sms), occupancy)


class SeqOut(NamedTuple):
    """One ``lstm_seq`` call's results: ``hs``, ``cs`` [T,B,H] and the last
    step's ``h_last``, ``c_last`` [B,H] in xz's dtype, and the final state
    ``h_state``, ``c_state`` [B,H] in the dtype it is carried in (f32; f64
    stays f64): what a caller carries into its next call (TBPTT chunks,
    ``rnn_time_step``), so that a bf16 run does not round the cell state at
    a chunk boundary when it does not inside a sequence."""
    hs: torch.Tensor
    cs: torch.Tensor
    h_last: torch.Tensor
    c_last: torch.Tensor
    h_state: torch.Tensor
    c_state: torch.Tensor


def lstm_seq_plain(xz, wh, h0, c0, wp=None, mask=None):
    """The contract of ``lstm_seq`` as a PyTorch time loop.

    xz [T,B,4H] (x.Wx + b, time-major, gates i|f|g|o), wh [H,4H], h0/c0
    [B,H], wp [3,H] (i|f|o peepholes) or None, mask [T,B] (1 = valid) or
    None. State is carried in f32 (f64 stays f64); h meets Wh in Wh's
    dtype. Returns a ``SeqOut``."""
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
    return SeqOut(torch.stack(hs).to(out), torch.stack(cs).to(out), h.to(out), c.to(out), h, c)


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


_sm_counts = {}
#: K chunks of the backward's per-step dh_prev product (see lstm_seq_bwd)
BWD_SPLIT_K = 16


def _sm_count(idx):
    if idx not in _sm_counts:
        props = torch.cuda.get_device_properties(idx)  # graftlint: disable=R5 -- only the kernel launch path calls it, for a CUDA tensor's device
        _sm_counts[idx] = props.multi_processor_count
    return _sm_counts[idx]


def _occupancy(lib, rt, h, xz, idx):
    """Persistent blocks at (rt, H, dtype) that fit on one SM of the card."""
    blocks = ctypes.c_int(0)
    err = lib.lstm_seq_occupancy(rt, h, int(xz.dtype == torch.bfloat16), idx,
                                 ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"lstm_seq_occupancy failed: CUDA error {err} "
                           f"({lib.lstm_seq_error_string(err).decode()})")
    return blocks.value


def lstm_seq_fwd(xz, wh, h0, c0, wp=None, mask=None):
    """The forward alone, outside autograd: CUDA tensors launch the Hopper
    kernel (f32 or bf16 xz/wh/wp, h0/c0 any float dtype), CPU tensors take
    the plain version. Returns a ``SeqOut``."""
    global launches
    if xz.device.type == "cpu":
        with torch.no_grad():
            return lstm_seq_plain(xz, wh, h0, c0, wp=wp, mask=mask)
    if xz.device.type != "cuda":
        raise ValueError(f"lstm_seq runs on cuda or cpu tensors, got {xz.device}")
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
    sms = _sm_count(idx)
    pl = launch_plan(t_len, b, hsz, xz.dtype, sms, lambda rt: _occupancy(lib, rt, hsz, xz, idx))
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
    _build.note_launch("lstm_seq", f"lstm_seq.variant.{pl.variant}")
    # both variants leave the final f32 state in h_state[T % 2] and c_state
    return SeqOut(hs, cs, h_last, c_last, h_state[t_len % 2], c_state)


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------

def lstm_seq_bwd(xz, wh, wp, h0, c0, mask, hs, cs, dhs, dhT, dcT, *, dcs=None):
    """Gradients of one ``lstm_seq`` call: (dxz, dwh, dwp, dh0, dc0) from
    its inputs, its saved ``hs``/``cs`` (xz's dtype) and the cotangents of
    ``hs`` (``dhs``), of the final h and c (``dhT``, ``dcT``) and of ``cs``
    (``dcs``), each None when zero. Port of ``lstm_pallas._bwd``:

    - the gates are recomputed from ``[h0; hs[:-1]]`` (rounded to Wh's
      dtype, as the forward's product takes it) and ``[c0; cs[:-1]]``;
      under a mask the pre-mask candidate cell is recomputed, without one
      ``cs`` is read; the o-gate peephole reads that candidate;
    - a masked step passes ``(1 - m) dh`` and ``(1 - m) dc`` through to the
      step before; the i/f peepholes feed ``dc_prev``;
    - every product runs on f32 (f64 for f64 inputs) operands: bf16
      values widened exactly, dz rounded to xz's dtype first (the JAX
      package's ``preferred_element_type=f32`` on bf16 operands), so dh is
      never rounded in the chain;
    - ``dxz`` comes back in xz's dtype, ``dwh`` summed in f32 and cast to
      Wh's dtype, ``dwp`` from the unrounded f32 gate cotangents."""
    t_len, b, four_h = xz.shape
    hsz = four_h // 4
    sd = torch.promote_types(xz.dtype, torch.float32)
    dev = xz.device
    with torch.no_grad(), torch.profiler.record_function("lstm_seq.backward"):
        h_prev = torch.cat([h0.to(wh.dtype)[None], hs[:-1].to(wh.dtype)]).to(sd)
        c_prev = torch.cat([c0.to(sd)[None], cs[:-1].to(sd)])
        whf = wh.to(sd)
        z = torch.addmm(xz.reshape(-1, four_h).to(sd), h_prev.view(-1, hsz), whf)
        zi, zf, zg, zo = z.view(t_len, b, four_h).split(hsz, dim=-1)
        wpf = None if wp is None else wp.to(sd)
        if wpf is not None:
            zi = zi + wpf[0] * c_prev
            zf = zf + wpf[1] * c_prev
        ig, fg, gg = torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg)
        # cs holds the post-mask cell; under a mask the candidate is recomputed
        c_cand = cs.to(sd) if mask is None else fg * c_prev + ig * gg
        og = torch.sigmoid(zo if wpf is None else zo + wpf[2] * c_cand)
        tc = torch.tanh(c_cand)
        del z, zi, zf, zg, zo
        # the step's chain written as factors of dh_cand and dc:
        #   dz_o = dh_cand * ko, dc = dh_cand * kc + dc_cand,
        #   dz_{i,f,g} = dc * k3, dc_prev = dc * kp + (1 - m) dc_total
        ko = tc * og * (1 - og)
        kc = og * (1 - tc * tc)
        k3 = torch.stack([gg * ig * (1 - ig), c_prev * fg * (1 - fg), ig * (1 - gg * gg)],
                         dim=2)  # [T, B, 3, H]
        kp = fg
        if wpf is not None:
            kc = kc + ko * wpf[2]
            kp = fg + k3[:, :, 0] * wpf[0] + k3[:, :, 1] * wpf[1]
        del ig, fg, gg, og, tc

        dz = torch.empty((t_len, b, four_h), dtype=xz.dtype, device=dev)  # dxz
        dc_all = torch.empty((t_len, b, 1, hsz), dtype=sd, device=dev)  # dc of each step
        dh_all = torch.empty((t_len, b, hsz), dtype=sd, device=dev)  # dh_cand of each step
        # dh_prev = dz . Wh^T with K = 4H split in BWD_SPLIT_K chunks, one batch of
        # a batched product each, summed after: at B=64 the single [B, 4H] x
        # [4H, H] product keeps only a few blocks busy for its whole K
        split = BWD_SPLIT_K if four_h % BWD_SPLIT_K == 0 else 1
        kq = four_h // split
        wh_tk = whf.t().contiguous().view(split, kq, hsz)
        parts = torch.empty((split, b, hsz), dtype=sd, device=dev)
        # every step's operands as views made once (the loop is host-bound)
        kc_s, ko_s, kp_s = (t.unsqueeze(2).unbind(0) for t in (kc, ko, kp))
        k3_s = k3.unbind(0)
        dz4 = dz.view(t_len, b, 4, hsz)
        dz3_s, dzo_s = dz4[:, :, :3].unbind(0), dz4[:, :, 3:].unbind(0)
        dzk_s = dz.view(t_len, b, split, kq).transpose(1, 2).unbind(0)  # [split, B, kq]
        dc_s = dc_all.unbind(0)
        dh2_s, dh3_s = dh_all.unbind(0), dh_all.unsqueeze(2).unbind(0)
        dhs_s = None if dhs is None else dhs.to(sd).unsqueeze(2).unbind(0)
        dcs_s = None if dcs is None else dcs.to(sd).unsqueeze(2).unbind(0)
        m_s = None if mask is None else mask.to(sd)[:, :, None, None].unbind(0)

        dh = dhs_s[-1].clone() if dhs_s is not None else \
            torch.zeros((b, 1, hsz), dtype=sd, device=dev)
        if dhT is not None:
            dh += dhT.to(sd).unsqueeze(1)
        dc = torch.zeros((b, 1, hsz), dtype=sd, device=dev) if dcT is None else \
            dcT.to(sd).unsqueeze(1)
        if m_s is None:
            dh3_s[-1].copy_(dh)
        for i in range(t_len - 1, -1, -1):
            if dcs_s is not None:
                dc = dc + dcs_s[i]
            if m_s is None:
                dh_c, dc_c = dh3_s[i], dc
            else:
                dh_c = torch.mul(dh, m_s[i], out=dh3_s[i])
                dc_c = dc * m_s[i]
            dcc = torch.addcmul(dc_c, dh_c, kc_s[i], out=dc_s[i])
            torch.mul(k3_s[i], dcc, out=dz3_s[i])
            torch.mul(ko_s[i], dh_c, out=dzo_s[i])
            dzk = dzk_s[i] if dz.dtype == sd else dzk_s[i].to(sd)
            torch.bmm(dzk, wh_tk, out=parts)
            if m_s is None:
                if i == 0:
                    dh = parts.sum(0)
                else:
                    torch.sum(parts, 0, out=dh2_s[i - 1])
                    if dhs_s is not None:
                        dh3_s[i - 1].add_(dhs_s[i - 1])
                dc = dcc * kp_s[i]
            else:
                pass_h = (1 - m_s[i]) * dh
                if i > 0 and dhs_s is not None:
                    pass_h += dhs_s[i - 1]
                dh = pass_h + parts.sum(0).unsqueeze(1)
                dc = torch.addcmul((1 - m_s[i]) * dc, dcc, kp_s[i])
        dh = dh.view(b, hsz)
        dc = dc.view(b, hsz)
        dc_all = dc_all.view(t_len, b, hsz)
        dz_f = dz.view(-1, four_h) if dz.dtype == sd else dz.view(-1, four_h).to(sd)
        dwh = torch.mm(h_prev.view(-1, hsz).t(), dz_f).to(wh.dtype)
        dwp = None
        if wpf is not None:
            dwp = torch.stack([(dc_all * k3[:, :, 0] * c_prev).sum((0, 1)),
                               (dc_all * k3[:, :, 1] * c_prev).sum((0, 1)),
                               (dh_all * ko * c_cand).sum((0, 1))]).to(wp.dtype)
    return dz, dwh, dwp, dh.to(h0.dtype), dc.to(c0.dtype)


class LstmSeqFunction(torch.autograd.Function):
    """``lstm_seq`` under autograd: the forward is ``lstm_seq_fwd`` (the
    kernel on CUDA tensors, the plain version on CPU tensors), the backward
    ``lstm_seq_bwd`` on both. Outputs hs, cs, h_state, c_state; it saves
    xz, wh, wp, h0, c0, mask and the forward's own hs and cs (xz's dtype),
    as the JAX package's ``_fwd`` does."""

    @staticmethod
    def forward(ctx, xz, wh, wp, h0, c0, mask):
        out = lstm_seq_fwd(xz, wh, h0, c0, wp=wp, mask=mask)
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xz, wh, wp, h0, c0, mask, out.hs, out.cs)
        return out.hs, out.cs, out.h_state, out.c_state

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dhs, dcs, dh_state, dc_state):
        xz, wh, wp, h0, c0, mask, hs, cs = ctx.saved_tensors
        dxz, dwh, dwp, dh0, dc0 = lstm_seq_bwd(xz, wh, wp, h0, c0, mask, hs, cs, dhs,
                                               dh_state, dc_state, dcs=dcs)
        return dxz, dwh, dwp, dh0, dc0, None


def lstm_seq(xz, wh, h0, c0, wp=None, mask=None):
    """LSTM over T steps (see ``lstm_seq_plain`` for the contract); returns
    a ``SeqOut``. CUDA tensors launch the Hopper kernel, CPU tensors take
    the plain version. When a gradient is asked for (grad mode on and an
    input that requires it) the call runs through ``LstmSeqFunction``, and
    ``h_last``/``c_last`` are the final state cast to xz's dtype (the
    values the kernel writes)."""
    if not (torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in (xz, wh, wp, h0, c0))):
        return lstm_seq_fwd(xz, wh, h0, c0, wp=wp, mask=mask)
    hs, cs, h_state, c_state = LstmSeqFunction.apply(xz, wh, wp, h0, c0, mask)
    return SeqOut(hs, cs, h_state.to(xz.dtype), c_state.to(xz.dtype), h_state, c_state)
