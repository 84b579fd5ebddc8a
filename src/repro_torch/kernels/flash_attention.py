"""Flash attention forward: causal or full, GQA, tanh logit softcap.

Replaces the Pallas TPU kernel `repro/kernels/flash_attention.py`
(`flash_attention`, body `_kernel`). Three forms:

* `attention_plain`: plain PyTorch, the reference's oracle
  `ref.attention_ref` op for op (f32 scores and softmax), on any device;
* `attention_cuda`: the hand-written kernel `csrc/flash_attention.cu`
  (online softmax over kv tiles, f32 running max, sum and accumulator);
* `attention`: the wrapper. CPU tensors take the plain version, CUDA
  tensors the kernel; anything else raises.

q is (B, H, Sq, D), k and v (B, K, Sk, D) with H % K == 0; query head h
reads kv head h // (H // K). The scale is D**-0.5, the softcap
cap * tanh(s / cap) comes after it, and the causal mask after that. The
output has q's type.

Causal attention takes Sq == Sk only. The reference disagrees with itself
otherwise: its Pallas kernel aligns the mask top-left (k_pos <= q_pos),
its oracle bottom-right (tril(k=Sk-Sq)). Prefill always has Sq == Sk.

What bounds it on the card: operations (4 B H Sq Sk D, halved under
causal) against q, k, v and out read or written once. See the .cu source
for the design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

#: launches of the CUDA kernel since the count was last set to 0
launches = 0

#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, causal):
    """(B, H, K, Sq, Sk, D) of a valid call; raises on anything else."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"attention: q, k, v must be 4-d, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    if (tuple(k.shape) != (B, K, Sk, D) or tuple(v.shape) != tuple(k.shape)
            or K == 0 or H % K):
        raise ValueError(f"attention: q (B, H, Sq, D) and k, v (B, K, Sk, "
                         f"D) with H % K == 0, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if causal and Sq != Sk:
        raise ValueError(
            f"attention: causal attention needs Sq == Sk, got Sq {Sq}, Sk "
            f"{Sk}; the reference aligns the mask top-left in its kernel "
            f"and bottom-right in its oracle, so no answer is the reference's")
    return B, H, K, Sq, Sk, D


def attention_plain(q, k, v, causal=True, softcap=None):
    """Plain PyTorch attention, as `ref.attention_ref` computes it."""
    B, H, K, Sq, Sk, D = _check(q, k, v, causal)
    qg = q.reshape(B, K, H // K, Sq, D).to(torch.float32)
    s = torch.einsum("bkgsd,bktd->bkgst", qg,
                     k.to(torch.float32)) * (D ** -0.5)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if causal:
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", p, v.to(torch.float32))
    return o.reshape(B, H, Sq, D).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _library():
    fn = build.load("flash_attention").flash_attention_launch
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn.argtypes = ([i, i] + [p] * 4 + [i] * 6
                   + [ctypes.POINTER(ctypes.c_longlong), i, f, f, p])
    fn.restype = i
    return fn


def attention_cuda(q, k, v, causal=True, softcap=None):
    """Launch `csrc/flash_attention.cu` on the current stream. q, k, v may
    be strided views (the model passes (B, S, heads, D) activations seen as
    (B, heads, S, D)) as long as D is contiguous; the output has q's
    layout."""
    global launches
    B, H, K, Sq, Sk, D = _check(q, k, v, causal)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError(f"attention: the kernel needs q, k, v on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"attention: the kernel takes float32 or bfloat16 "
                         f"q, k, v of one type, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"attention: the kernel takes head dims "
                         f"{KERNEL_HEAD_DIMS}, got {D}")
    if any(x.stride(3) != 1 for x in (q, k, v)):
        raise ValueError("attention: the head dim must be contiguous")
    if B * H > 65535 or Sk == 0:
        raise ValueError(f"attention: the kernel takes B * H <= 65535 and "
                         f"Sk > 0, got B * H = {B * H}, Sk = {Sk}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"attention: softcap must be positive, got "
                         f"{softcap}")
    out = torch.empty_like(q)  # q's strides when q is dense
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 12)(*[
        s for x in (q, k, v, out) for s in (x.stride(0), x.stride(1),
                                            x.stride(2))])
    err = _library()(
        dev.index if dev.index is not None else torch.cuda.current_device(),
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, H, K, Sq, Sk, D, strides, int(bool(causal)),
        D ** -0.5, 0.0 if softcap is None else float(softcap),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    launches += 1
    return out


def attention(q, k, v, causal=True, softcap=None):
    """Flash attention forward: q (B, H, Sq, D), k/v (B, K, Sk, D) ->
    (B, H, Sq, D) in q's type. The plain version for CPU tensors, the
    CUDA kernel for CUDA ones."""
    kind = q.device.type
    if kind == "cpu":
        return attention_plain(q, k, v, causal=causal, softcap=softcap)
    if kind == "cuda":
        return attention_cuda(q, k, v, causal=causal, softcap=softcap)
    raise ValueError(f"attention: no kernel for device {q.device}")
