"""Flash attention: the CUDA kernels of ``csrc/flash_attention.cu`` and
their plain PyTorch version.

The counterpart of the JAX package's Pallas kernel
``repro/kernels/flash_attention.py:flash_attention``: online-softmax
attention over ``(BH, S, d)`` whose running max, denominator and output
accumulator stay in fast memory for one query tile while the KV tiles go
by, with whole KV tiles above the causal diagonal skipped.  There the KV
axis is the innermost, sequential grid axis; on the card one thread block
owns a query tile and walks the KV tiles itself.  Three kernels, chosen
from the operands before the launch by :func:`attention_path`:
``"wgmma"``, bf16 at any d % 8 == 0 with operands a TMA tensor map reads,
on the tensor cores with ``wgmma`` fed by a TMA ring, over 128 x 128 tiles
(:data:`BLOCK_Q`, :data:`BLOCK_K`; the head zero-filled by TMA to a 64- or
128-column tile); ``"mma_sync"``, any other bf16 on the tensor cores with
``mma.sync``, over 64 x 64 tiles (:data:`MMA_BLOCK_Q`, :data:`MMA_BLOCK_K`);
``"f32"``,
f32 on the CUDA cores, since the tensor cores would round f32 to TF32, over
the same 64 x 64 tiles (see the source).  The kernels handle ragged edges,
so unlike the Pallas kernel they take any Sq and Sk and need no
``sk_valid``, and they take k and v with fewer heads than q (GQA,
``group`` q heads a kv head) without copying them out.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..device import PLAIN_DEVICES
from . import _launch
from .ref import NEG_INF

DTYPES = (torch.float32, torch.bfloat16)
#: The wgmma kernel's query tile and KV tile, the mma.sync and f32
#: kernels' query tile and KV tile, and the widest head any takes: the
#: plain version run with a kernel's tiles (:func:`kernel_tiles`) takes
#: that kernel's running maxima, so it rounds p at the same places.
BLOCK_Q = 128
BLOCK_K = 128
MMA_BLOCK_Q = 64
MMA_BLOCK_K = 64
MAX_D = 128
#: Each path's code in the C launcher.
_PATH_CODE = {"f32": 0, "mma_sync": 1, "wgmma": 2}
_INT_MAX = 2**31 - 1
_GRID_Y_MAX = 65535


def _library():
    """Build (first use) and bind the kernel's C entry point."""
    from . import _build

    lib = _build.load("flash_attention").lib
    if getattr(lib, "_bound", False):
        return lib
    fns = (lib.flash_attention_block_q, lib.flash_attention_block_k,
           lib.flash_attention_mma_block_q, lib.flash_attention_mma_block_k,
           lib.flash_attention_max_d)
    for fn in fns:
        fn.restype, fn.argtypes = ctypes.c_int, []
    if tuple(fn() for fn in fns) != (BLOCK_Q, BLOCK_K, MMA_BLOCK_Q,
                                     MMA_BLOCK_K, MAX_D):
        raise RuntimeError("csrc/flash_attention.cu was built for another "
                           "tile or head width than flash_attention.py's")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.restype = i
    lib.flash_attention_launch.argtypes = [p, p, p, p] + [i] * 6 + [
        ctypes.c_float, i, p]
    lib._bound = True
    return lib


def attention_path(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> str:
    """Which kernel takes attention of q over k, v on the card:
    ``"wgmma"`` for bf16 at d % 8 == 0, d <= :data:`MAX_D`, with q, k
    and v contiguous and 16-byte aligned (what a TMA tensor map reads: a
    base and a row stride of 2 d bytes, multiples of 16); ``"mma_sync"``
    for any other bf16; ``"f32"`` for f32.  Decided from the operands
    alone, before any launch."""
    if q.dtype != torch.bfloat16:
        return "f32"
    d = q.shape[-1]
    tma = all(t.is_contiguous() and t.data_ptr() % 16 == 0
              for t in (q, k, v))
    return "wgmma" if tma and d % 8 == 0 and d <= MAX_D else "mma_sync"


def kernel_tiles(path: str) -> tuple[int, int]:
    """The (query, KV) tiles of kernel ``path``: the tiles at which the
    plain version rounds p where that kernel does."""
    return (BLOCK_Q, BLOCK_K) if path == "wgmma" else (MMA_BLOCK_Q,
                                                        MMA_BLOCK_K)


def _check_shapes(q, k, v, group: int, bq: int, bk: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (BH, Sq, d) and "
                         f"(BH / group, Sk, d)")
    bh, _, d = q.shape
    if group < 1 or k.shape[0] * group != bh or k.shape[2] != d:
        raise ValueError(f"k {tuple(k.shape)} does not serve q "
                         f"{tuple(q.shape)} in groups of {group}")
    if k.shape[1] < 1 or d < 1:
        raise ValueError("attention needs at least one key and d >= 1")
    if bq < 1 or bk < 1:
        raise ValueError(f"tiles bq={bq}, bk={bk} must be positive")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k and v lie on {q.device}, {k.device} and "
                         f"{v.device}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool, group: int = 1, bq: int = 128,
                          bk: int = 128, q_offset: int = 0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, tile by tile as the Pallas
    kernel computes it: query tiles of ``bq`` rows, KV tiles of ``bk`` keys
    ascending from 0 (tiles wholly above the causal diagonal skipped),
    scores in f32 scaled after the product, masked scores -1e30, running
    (m, l, acc) in f32, p rounded to v's dtype before the p v product, and
    acc / max(l, 1e-30) in q's dtype.  Shapes as :func:`flash_attention`.
    ``q_offset`` is the absolute position of q's first row in the causal
    mask (query i sees keys j <= q_offset + i; the kernel has none: 0).
    The model's blockwise path (``models.layers.blockwise_attention``) is
    this function with its chunks as the tiles."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    if group > 1:                       # kv head h // group serves q head h
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = 1.0 / math.sqrt(d)
    f32 = torch.float32
    out = torch.empty_like(q)
    for q0 in range(0, sq, bq):
        qi = q[:, q0:q0 + bq]
        rows = qi.shape[1]
        qpos = torch.arange(q_offset + q0, q_offset + q0 + rows,
                            device=q.device)[:, None]
        m = torch.full((bh, rows), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((bh, rows), dtype=f32, device=q.device)
        acc = torch.zeros((bh, rows, d), dtype=f32, device=q.device)
        for k0 in range(0, sk, bk):
            if causal and k0 > q_offset + q0 + bq - 1:
                break
            kj, vj = k[:, k0:k0 + bk], v[:, k0:k0 + bk]
            s = torch.matmul(qi.to(f32), kj.to(f32).transpose(1, 2)) * scale
            if causal:
                kpos = torch.arange(k0, k0 + kj.shape[1], device=q.device)
                s = torch.where(kpos[None, :] <= qpos, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(v.dtype).to(f32), vj.to(f32))
            m = m_new
        out[:, q0:q0 + rows] = (acc / torch.clamp(l, min=1e-30)[..., None]
                                ).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, group: int = 1, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """Softmax attention of q (BH, Sq, d) over k, v (BH / group, Sk, d), in
    q's dtype; q row bh reads kv row bh // group.

    CPU (and meta) tensors take :func:`flash_attention_plain` with tiles
    (``bq``, ``bk``); CUDA tensors (f32 or bf16, d <= 128) launch the kernel that
    :func:`attention_path` names on the current stream, with that kernel's
    own tiles, and count the launch in ``flash_attention.launches`` and,
    by kernel, in ``flash_attention.launches_by_path``.  Nothing falls
    back."""
    _check_shapes(q, k, v, group, bq, bk)
    if q.device.type in PLAIN_DEVICES:
        return flash_attention_plain(q, k, v, causal=causal, group=group,
                                     bq=bq, bk=bk)
    return launch(q, k, v, attention_path(q, k, v), causal=causal,
                  group=group)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, path: str, *,
           causal: bool, group: int = 1) -> torch.Tensor:
    """Launch kernel ``path`` (``"wgmma"``, ``"mma_sync"`` or ``"f32"``) on
    CUDA tensors and count it.  :func:`flash_attention` takes the path from
    :func:`attention_path`; naming ``"mma_sync"`` for operands the wgmma
    kernel takes runs the mma.sync kernel on them, as timing the two side
    by side needs."""
    _check_shapes(q, k, v, group, 1, 1)
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU tensors, got "
                         f"{device}")
    _launch.check_input("q", q, device, DTYPES, 3)
    _launch.check_input("k", k, device, (q.dtype,), 3)
    _launch.check_input("v", v, device, (q.dtype,), 3)
    if path not in _PATH_CODE:
        raise ValueError(f"no attention kernel {path!r}")
    if path != attention_path(q, k, v) and not (
            path == "mma_sync" and q.dtype == torch.bfloat16):
        raise ValueError(f"the {path} kernel does not take {q.dtype} "
                         f"q {tuple(q.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    if d > MAX_D:
        raise ValueError(f"head width d={d}: the kernel takes d <= {MAX_D}")
    if max(bh, sq * d, sk * d) > _INT_MAX \
            or -(-sq // kernel_tiles(path)[0]) > _GRID_Y_MAX:
        raise ValueError(f"q {tuple(q.shape)} exceeds the kernel's grid")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = _library()
    with torch.cuda.device(device):
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh, sq,
            sk, d, group, int(causal), 1.0 / math.sqrt(d), _PATH_CODE[path],
            _launch.stream(device))
    _launch.check_status(err, f"flash_attention ({path})")
    _wrapper.launches += 1
    _wrapper.launches_by_path[path] += 1
    return out


#: ``flash_attention.launches`` counts launches of the CUDA kernels (calls
#: that take the plain version do not count), and
#: ``flash_attention.launches_by_path`` each kernel's, through this alias.
_wrapper = flash_attention
flash_attention.launches = 0
flash_attention.launches_by_path = {"wgmma": 0, "mma_sync": 0, "f32": 0}
