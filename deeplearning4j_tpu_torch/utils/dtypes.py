"""Dtype policy: a (param, compute, accumulation) triple of torch dtypes.

The default is all float32. ``bf16_policy`` keeps float32 parameters and
accumulation with bfloat16 matmul operands. float64 inputs stay float64.

``policy_precision`` is the context the networks' entry points run in: under
a float32 compute dtype it turns cuDNN's TF32 off (PyTorch leaves it on by
default), so a float32 convolution runs in full float32 as the JAX
package's do; under bf16 it leaves the flag as it is.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.float32
    accum_dtype: torch.dtype = torch.float32


_POLICY = DtypePolicy()


def get_policy() -> DtypePolicy:
    return _POLICY


def set_policy(param_dtype=None, compute_dtype=None, accum_dtype=None) -> DtypePolicy:
    global _POLICY
    _POLICY = DtypePolicy(
        param_dtype=param_dtype if param_dtype is not None else _POLICY.param_dtype,
        compute_dtype=compute_dtype if compute_dtype is not None else _POLICY.compute_dtype,
        accum_dtype=accum_dtype if accum_dtype is not None else _POLICY.accum_dtype,
    )
    return _POLICY


def compute_dtypes_for(x_dtype):
    """(compute, accum) dtypes for an input dtype. float64 inputs stay in
    float64; everything else follows the global policy."""
    if x_dtype == torch.float64:
        return torch.float64, torch.float64
    pol = get_policy()
    return pol.compute_dtype, pol.accum_dtype


def bf16_policy() -> DtypePolicy:
    """f32 params, bf16 compute, f32 accumulation."""
    return set_policy(param_dtype=torch.float32, compute_dtype=torch.bfloat16,
                      accum_dtype=torch.float32)


def f32_policy() -> DtypePolicy:
    return set_policy(param_dtype=torch.float32, compute_dtype=torch.float32,
                      accum_dtype=torch.float32)


_tf32_lock = threading.Lock()
_tf32_depth = 0
_tf32_saved = None


@contextlib.contextmanager
def policy_precision():
    """Within this block cuDNN's TF32 is off when the policy computes in
    float32; the value it had comes back when the outermost such block
    ends (blocks nest and may run on several threads at once).
    ``torch.backends.cudnn.flags`` is not used: it also resets
    ``benchmark`` and ``deterministic`` to its own defaults."""
    global _tf32_depth, _tf32_saved
    if get_policy().compute_dtype != torch.float32:
        yield
        return
    with _tf32_lock:
        if _tf32_depth == 0:
            _tf32_saved = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _tf32_depth += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_depth -= 1
            if _tf32_depth == 0:
                torch.backends.cudnn.allow_tf32 = _tf32_saved
