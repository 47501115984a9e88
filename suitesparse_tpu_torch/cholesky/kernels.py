"""Dense kernels of the supernodal factor: the counterpart of
suitesparse_tpu/cholesky/pallas_kernels.py.

``block_chol`` is the batched factor of the (W, Np, Np) diagonal blocks.
On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/block_chol.cu`` (which replaces the Pallas ``_chol_kernel``); on a
CPU tensor it runs ``block_chol_plain``, the same function written with
tensor ops.  ``panel_factor`` wraps it with the TRSM (an explicit
triangular inverse and one batched product) and the in-place trailing
update over 128-wide slabs, as the reference does outside Pallas.

The Pallas kernel's batch tile ``_WC`` and its identity-block padding are
TPU compile choices, not semantics: the CUDA kernel takes any W.
"""
from __future__ import annotations

import torch

from ..utils import cuda_build

__all__ = ["block_chol", "block_chol_plain", "panel_factor"]

_KERNEL_MAX_NP = 128


def block_chol_plain(S: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``block_chol``: right-looking column loop with a
    rank-1 update, in the kernel's orientation (A[:, c, r] = L[r, c])."""
    A = S + torch.diag_embed(pe)
    Np = A.shape[-1]
    for c in range(Np):
        d = torch.rsqrt(A[:, c, c])            # unclamped: pivot <= 0 -> NaN
        A[:, c, c:] *= d[:, None]
        row = A[:, c, c + 1:]                  # L[c+1:, c]
        A[:, c + 1:, c + 1:] -= row[:, :, None] * row[:, None, :]
    return torch.triu(A)


def block_chol(S: torch.Tensor, pe: torch.Tensor) -> torch.Tensor:
    """U = chol(S + diag(pe))^T for a SYMMETRIC batch S (W, Np, Np).

    Returns the upper-triangular transpose of the Cholesky factor, with
    exact zeros below the diagonal; a non-positive pivot gives NaN.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (float32 or float64, Np a multiple of 8 up to 128) or raises."""
    if S.device.type == "cpu":
        return block_chol_plain(S, pe)
    if S.device.type != "cuda":
        raise ValueError(f"block_chol: unsupported device {S.device}")
    if S.dim() != 3 or S.shape[1] != S.shape[2]:
        raise ValueError(f"block_chol: S must be (W, Np, Np), got "
                         f"{tuple(S.shape)}")
    W, Np, _ = S.shape
    if Np % 8 or not 8 <= Np <= _KERNEL_MAX_NP:
        raise ValueError(f"block_chol: Np={Np} must be a multiple of 8 in "
                         f"[8, {_KERNEL_MAX_NP}]")
    if S.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"block_chol: dtype {S.dtype} (float32/float64)")
    if tuple(pe.shape) != (W, Np) or pe.dtype != S.dtype \
            or pe.device != S.device:
        raise ValueError("block_chol: pe must be (W, Np) of S's dtype and "
                         "device")
    if not (S.is_contiguous() and pe.is_contiguous()):
        raise ValueError("block_chol: S and pe must be contiguous")
    out = torch.empty_like(S)
    if W == 0:
        return out
    cuda_build.launch("sstpu_block_chol_f32" if S.dtype == torch.float32
                      else "sstpu_block_chol_f64", S, S.data_ptr(),
                      pe.data_ptr(), out.data_ptr(), W, Np)
    block_chol.launches += 1
    return out


# Launches of the kernel: one for each call above, and for each replay of a
# captured device program the number its capture recorded (a replay makes
# no Python call; utils/programs.py adds them)
block_chol.launches = 0


def _tri_inv_upper_pow2(U: torch.Tensor, base: int = 2) -> torch.Tensor:
    """Batched UPPER-triangular inverse via batch-folded block recursion:

        inv([[A, B], [0, D]]) = [[iA, -iA B iD], [0, iD]]

    bottoming out at closed-form 2x2 inverses, then log2(Np/2) levels of
    batched products.  Np must be a power of two."""
    W, Np, _ = U.shape
    blocks = U
    stack = []
    m = Np
    while m > base:
        h = m // 2
        stack.append(blocks[:, :h, h:])
        blocks = torch.cat([blocks[:, :h, :h], blocks[:, h:, h:]], dim=0)
        m = h
    if m == 2:
        # inv([[a,b],[0,d]]) = [[1/a, -b/(a d)], [0, 1/d]] -- elementwise
        ia = 1.0 / blocks[:, 0, 0]
        idd = 1.0 / blocks[:, 1, 1]
        off = -blocks[:, 0, 1] * ia * idd
        z = torch.zeros_like(ia)
        inv = torch.stack([torch.stack([ia, off], dim=1),
                           torch.stack([z, idd], dim=1)], dim=1)
    else:
        eye = torch.eye(m, dtype=U.dtype, device=U.device).expand_as(blocks)
        inv = torch.linalg.solve_triangular(blocks, eye, upper=True)
    while stack:
        Bblk = stack.pop()
        half = inv.shape[0] // 2
        iA, iD = inv[:half], inv[half:]
        iB = -((iA @ Bblk) @ iD)
        h = Bblk.shape[1]
        top = torch.cat([iA, iB], dim=2)
        bot = torch.cat([U.new_zeros((half, Bblk.shape[2], h)), iD], dim=2)
        inv = torch.cat([top, bot], dim=1)
    return inv


def panel_factor(P: torch.Tensor, pe: torch.Tensor, rm: torch.Tensor,
                 cm: torch.Tensor) -> torch.Tensor:
    """Fused POTRF + TRSM of a panel wave: ``block_chol`` on 128-wide
    diagonal slabs + batch-folded inverse TRSM + in-place trailing update.

    P:  (W, Mp, Np) panels -- rows [0, Np) hold the (junk-above-diagonal)
        symmetric diagonal block, rows [Np, Mp) the below-diagonal block.
    pe: (W, Np) 1.0 on padded diagonal rows.
    rm: (W, Mp) row mask; cm: (W, Np) column mask.
    Returns the masked factored panels: L in the lower triangle of the top
    block (upper zeroed), B L^-T in the below rows.  P is not modified.
    """
    W, Mp, Np = P.shape
    BB = min(Np, 128)
    # A starts as a copy of P and becomes the result slab by slab: the
    # reference's dynamic_update_slice of the trailing block is an in-place
    # subtraction here, and each finished slab overwrites its own columns
    A = P.clone()
    for a in range(0, Np, BB):
        b = a + BB
        S = torch.tril(A[:, a:b, a:b])
        S = S + torch.tril(S, -1).transpose(1, 2)
        Ut = block_chol(S.contiguous(), pe[:, a:b].contiguous())  # U = L^T
        A[:, :a, a:b] = 0
        A[:, a:b, a:b] = Ut.transpose(1, 2)
        if b < Mp:
            # TRSM: Bm = B L^-T = B @ inv(U); one batched product
            Lb = A[:, b:, a:b] @ _tri_inv_upper_pow2(Ut)
            A[:, b:, a:b] = Lb
            if b < Np:
                # trailing update of rows b..Mp, columns b..Np, in place
                A[:, b:, b:] -= Lb @ Lb[:, :Np - b, :].transpose(1, 2)
    return A * rm[:, :, None] * cm[:, None, :]
