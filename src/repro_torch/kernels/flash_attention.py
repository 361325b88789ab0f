"""Blocked GQA flash attention, forward only.

:func:`flash_attention` launches one of two hand-written CUDA kernels on
CUDA tensors and runs its plain tensor-op version
:func:`flash_attention_plain` on CPU tensors; it replaces
``src/repro/kernels/flash_attention.py::_flash_single`` (``_flash_kernel``)
behind that module's public ``flash_attention``.  The kernel follows from
q's dtype and head dim alone, before the launch (:func:`variant`):

* ``sm90`` (``csrc/flash_attention_sm90.cu``): bfloat16 and float16 at
  head dims 64, 96 and 128, on the tensor cores (``wgmma``, TMA);
* ``mma`` (``csrc/flash_attention.cu``): everything else — float32 at any
  head dim, 16-bit types at other widths up to 256 — on the TF32 tensor
  cores (``mma.sync`` m16n8k8) with float32 operands split into a TF32
  ``hi`` and ``lo`` (:func:`tf32_split`) and each product taken as
  ``lo·hi + hi·lo + hi·hi`` ("3xTF32"): three passes for both products in
  float32; for 16-bit inputs, exact in TF32, one pass for ``Q·Kᵀ`` and two
  (``P_hi·V + P_lo·V``) for ``P·V``.

Query head ``h`` reads kv head ``h // (Hq // Hkv)``, as JAX's
``reshape(b, hkv, group, sq, d)`` maps them.  The scores, the softmax and
its state are float32 whatever the input dtype, and the output has q's
dtype.  The ``mma`` kernel keeps the probabilities at float32 precision
for their product with V, as JAX does; the ``sm90`` kernel rounds them to
q's 16-bit type.

The causal mask is top-left aligned: query ``i`` sees keys ``j <= i`` for
any ``Sq`` and ``Sk``, as the TPU kernel's ``qpos >= kpos`` does.  The JAX
package's own oracle, ``repro.kernels.ref.attention_ref``, aligns it
bottom-right (``tril(k=sk - sq)``), so the two agree only where ``Sq ==
Sk`` (ROADMAP fault R6).  The port copies each: this module follows the
kernel, ``kernels/ref.py::attention_ref`` the oracle.

JAX's kernel has no VJP, so there is no backward here either: the wrapper
is not an ``autograd.Function`` and its output carries no gradient.
"""
from __future__ import annotations

import torch

from . import _build

_LIB = "flash_attention"
_SM90 = "flash_attention_sm90"
NEG_INF = -1e30
# the sm90 kernel's dtypes and head dims; its tiles, from its source
SM90_DTYPES = (torch.bfloat16, torch.float16)
SM90_HEAD_DIMS = (64, 96, 128)
SM90_BM = _build.source_define(_SM90, "FA9_BM")    # query rows of a block
# query rows per score block of the plain version: a (B, Hq, 512, Sk) fp32
# block at a time, not the whole (B, Hq, Sq, Sk)
PLAIN_CHUNK = 512


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain tensor-op version: float32 scores scaled by ``1/sqrt(D)`` after
    the product, the top-left causal mask, float32 softmax,
    :data:`PLAIN_CHUNK` query rows at a time; the output in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / d ** 0.5
    qg = q.float().reshape(b, hkv, group, sq, d)
    kt = k.float().transpose(-1, -2)                     # (B, Hkv, D, Sk)
    vf = v.float()
    kpos = torch.arange(sk, device=q.device)
    out = torch.empty(b, hkv, group, sq, d, dtype=q.dtype, device=q.device)
    for lo in range(0, sq, PLAIN_CHUNK):
        hi = min(sq, lo + PLAIN_CHUNK)
        qc = qg[:, :, :, lo:hi].reshape(b, hkv, group * (hi - lo), d)
        s = (torch.matmul(qc, kt) * scale).view(b, hkv, group, hi - lo, sk)
        if causal:
            qpos = torch.arange(lo, hi, device=q.device)
            s = s.masked_fill(qpos[:, None] < kpos[None, :], NEG_INF)
        p = torch.softmax(s, dim=-1).view(b, hkv, group * (hi - lo), sk)
        out[:, :, :, lo:hi] = torch.matmul(p, vf).view(
            b, hkv, group, hi - lo, d).to(q.dtype)
    return out.view(b, hq, sq, d)


def _check_inputs(q, k, v, block_q: int, block_k: int) -> None:
    """The JAX entry point's preconditions, as errors: ``ValueError`` on
    shapes (``Hq % Hkv``, ``Sq % block_q``, ``Sk % block_k``), ``TypeError``
    on a dtype other than float32, bfloat16 and float16, or on q, k and v of
    different dtypes."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q (B, Hq, Sq, D) and k, v "
                         f"(B, Hkv, Sk, D) expected, got q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention: q heads {hq} are not a multiple "
                         f"of kv heads {hkv}")
    if block_q <= 0 or block_k <= 0 or sq % block_q or sk % block_k:
        raise ValueError(f"flash_attention: Sq {sq} and Sk {sk} must be "
                         f"multiples of block_q {block_q} and block_k "
                         f"{block_k}")
    if q.dtype not in _build.FLOAT_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k and v must share one dtype "
                        f"of float32, bfloat16 or float16, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that attention at ``dtype`` and head dim ``d`` launches:
    ``"sm90"`` for a 16-bit type at a width of :data:`SM90_HEAD_DIMS`,
    else ``"mma"``."""
    return "sm90" if dtype in SM90_DTYPES and d in SM90_HEAD_DIMS else "mma"


def _tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (add half a TF32 unit to the magnitude's bits, then
    drop the low 13), as ``cvt.rna.tf32.f32`` does; inf and NaN pass."""
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    r = torch.where(torch.isfinite(x), (bits + 0x1000) & 0xFFFFE000, bits)
    return torch.where(r >= 1 << 31, r - (1 << 32), r).to(
        torch.int32).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(hi, lo)``: the ``mma`` kernel's split of each float32 operand,
    ``hi = rna_tf32(x)`` and ``lo = rna_tf32(x - hi)``, as float32 tensors
    whose low 13 mantissa bits are zero.  ``hi + lo`` is ``x`` within
    2**-21 relative; a bfloat16 or float16 value gives ``lo = 0``.  Plain
    torch, for the tests that hold the kernel's arithmetic to JAX's."""
    x = x.float()
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` with a 16-byte aligned start, as a tensor map needs (a
    contiguous view into a larger tensor may start anywhere)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(lib: str, q, k, v, causal: bool) -> torch.Tensor:
    """One launch of ``lib``'s kernel (both take the same arguments) on
    contiguous CUDA tensors of one dtype; returns its output."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    dev = q.device
    out = torch.empty_like(q)
    qp, code = _build.require_float(lib, q, q.dtype, "q")
    fn = _build.launcher(lib, "ppppiiiiiiiiip")
    rc = fn(qp, _build.require_float(lib, k, q.dtype, "k")[0],
            _build.require_float(lib, v, q.dtype, "v")[0], out.data_ptr(),
            code, b, hq, hkv, sq, sk, d, int(bool(causal)), dev.index or 0,
            _build.stream_of(dev))
    _build.check(lib, rc)
    return out


def flash_attention_sm90(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True) -> torch.Tensor:
    """One launch of ``csrc/flash_attention_sm90.cu`` on contiguous CUDA
    tensors of one 16-bit dtype at a head dim of :data:`SM90_HEAD_DIMS` (as
    :func:`flash_attention` checked them); raises on anything else."""
    b, sq, d = q.shape[0], q.shape[2], q.shape[3]
    if variant(q.dtype, d) != "sm90":
        raise ValueError(f"{_SM90}: takes bfloat16 or float16 at head dims "
                         f"{SM90_HEAD_DIMS}, got {q.dtype} at {d}")
    if b > 65535 or -(-sq // SM90_BM) > 65535:
        raise ValueError(f"{_SM90}: batch {b} and query tiles "
                         f"{-(-sq // SM90_BM)} must each be at most 65535 "
                         "(grid dimensions)")
    need = _build.function(_SM90, f"{_SM90}_smem_bytes", "i", "q")(d)
    if need + _build.STATIC_SMEM_RESERVE > _build.max_smem(_SM90, q.device):
        raise ValueError(f"{_SM90}: {need} bytes of shared memory do not "
                         f"fit a block on {q.device}")
    out = _launch(_SM90, _aligned(q), _aligned(k), _aligned(v), causal)
    flash_attention_sm90.launches += 1
    return out


flash_attention_sm90.launches = 0


def flash_attention_mma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """One launch of ``csrc/flash_attention.cu`` (3xTF32 products on the
    tensor cores, head dims up to 256) on contiguous CUDA tensors of one
    dtype, as :func:`flash_attention` checked them."""
    b, hq, d = q.shape[0], q.shape[1], q.shape[3]
    need = _build.function(_LIB, "flash_attention_smem_bytes", "ii", "q")(
        d, _build.FLOAT_CODES[q.dtype])
    if need < 0 or need + _build.STATIC_SMEM_RESERVE > _build.max_smem(
            _LIB, q.device):
        raise ValueError(f"flash_attention: head dim {d} does not fit the "
                         f"kernel's shared-memory tiles on {q.device} (at "
                         "most 256)")
    if max(b, hq) > 65535:
        raise ValueError(f"flash_attention: batch {b} and q heads {hq} must "
                         "each be at most 65535 (grid dimensions)")
    out = _launch(_LIB, q, k, v, causal)
    flash_attention_mma.launches += 1
    return out


flash_attention_mma.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Attention of q ``(B, Hq, Sq, D)`` over k, v ``(B, Hkv, Sk, D)`` →
    ``(B, Hq, Sq, D)`` in q's dtype.  ``block_q`` and ``block_k`` are the
    TPU kernel's tiles: they must divide ``Sq`` and ``Sk``, as there, and
    change nothing else; the CUDA kernels pick their own tiles.  On CUDA
    tensors the kernel is :func:`variant`'s, with no other: one that
    cannot build or launch raises.  Forward only."""
    _check_inputs(q, k, v, block_q, block_k)
    dev = _build.kernel_device(_LIB, q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if dev is None:
        return flash_attention_plain(q, k, v, causal=causal)
    if q.numel() == 0:
        return torch.empty_like(q)
    launch = (flash_attention_sm90 if variant(q.dtype, q.shape[3]) == "sm90"
              else flash_attention_mma)
    out = launch(q, k, v, causal=causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
